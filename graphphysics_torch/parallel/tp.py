"""Tensor parallelism over the model group (counterpart of
``graphphysics_tpu/parallel/tp.py``).

The JAX package annotates the parameters' shardings and lets XLA's SPMD
partitioner insert the all-reduces. The port spells the same Megatron
pairing out on the ``T`` ranks of the model axis (``parallel.mesh``): each
rank keeps its slice of every sharded weight, the graph and every other
parameter replicated, and two autograd functions carry the collectives:

- ``copy_to_group``: the identity forward; the backward all-reduces the
  input's gradient (the replicated input of a column-parallel layer);
- ``reduce_from_group``: all-reduces forward (the partial products of a
  row-parallel layer); the identity backward.

The rule (``tp_param_specs``, the JAX ``_spec_for`` read on the port's
module types): an ``MLP``'s even Linears are column-parallel (output rows
and bias sharded), its odd ones row-parallel (input columns sharded, the
bias replicated and added after the all-reduce); ``Attention``'s
``q_proj``, ``k_proj`` and ``v_proj`` are column-parallel and ``proj``
row-parallel; a ``GatedMLPBlock``'s ``linear1`` and ``linear2`` are
column-parallel and its output Linear row-parallel. Norms, normalizers and
the GMM heads are replicated. So each column/row pair costs one all-reduce
forward and one backward. The backward's lands on the narrowest tensor
that feeds only the column-parallel layer: the input an ``Attention``'s
q, k, v or a ``GatedMLP``'s two Linears share, once; a ``GraphNetBlock``'s
node and edge tables before its edge MLP gathers them (``N + E`` rows,
not the ``E`` rows three tables wide of the concatenation).

Heads are interleaved: ``Attention`` reads q, k and v as ``(N, head_dim,
H)``, so head ``h`` owns the columns ``d * H + h``. A rank's q, k, v rows
(and ``proj``'s input columns) are the index set ``{d * H + h : h in its
heads}`` in ``(d, h_local)`` order, so its local tensors are again the
interleaved layout of ``H / T`` heads, which the attention kernels take as
they are; the scores keep the model's ``num_heads ** -0.5``. ``T`` must
divide the head count and every sharded width (the JAX package shards any
width through GSPMD); ``shard_tp_state`` raises otherwise.

``shard_tp_state(sim, optimizer)`` puts the simulator (and the optimizer's
moments, ``opt_state_specs``) on this rank's slices in place;
``gather_tp_state_dict`` gives back the full reference-named ``state_dict``
(or the full gradients) on every rank, what reading a JAX global array
gives. ``make_tp_train_step`` has the single-device step's semantics.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from graphphysics_torch.models.layers import (
    MLP,
    Attention,
    GatedMLP,
    GatedMLPBlock,
    GraphNetBlock,
)
from graphphysics_torch.parallel.mesh import MODEL_AXIS, axis_rank, axis_size, graph_group
from graphphysics_torch.training.losses import make_local_loss


class TPSpec(NamedTuple):
    """A sharded parameter: ``kind`` "column" or "row", ``dim`` the torch
    dimension cut (0: output rows; 1: input columns), ``heads`` the
    attention's head count where the cut keeps whole interleaved heads."""

    kind: str
    dim: int
    heads: Optional[int] = None


class _Plan(NamedTuple):
    """A Linear to shard: its owner and attribute, its kind, and the heads
    of an attention projection (None: a contiguous split)."""

    parent: nn.Module
    attr: str
    linear: nn.Linear
    kind: str
    heads: Optional[int]
    copy_input: bool


# the model group's all-reduces, forward and backward: calls and bytes of
# each rank's tensor
ALL_REDUCES = {"calls": 0, "bytes": 0}


def _all_reduce(t: torch.Tensor, axis_name: str) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, group=graph_group(axis_name))
    ALL_REDUCES["calls"] += 1
    ALL_REDUCES["bytes"] += t.numel() * t.element_size()
    return t


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis_name), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        return _all_reduce(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """``x`` itself; its gradient all-reduced over ``axis_name``'s group."""
    return _CopyToGroup.apply(x, axis_name)


def reduce_from_group(x: torch.Tensor, axis_name: str = MODEL_AXIS) -> torch.Tensor:
    """``x`` summed over ``axis_name``'s group; its gradient as it is."""
    return _ReduceFromGroup.apply(x, axis_name)


def _linear(x, weight, bias, dtype):
    """``Linear.forward`` on these weights: one fused product with the bias
    in f32, or the product and then the bias in ``dtype``."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class ColumnParallelLinear(nn.Module):
    """This rank's output rows of a Linear (a ``SplitDense`` too: then it
    takes ``(parts, posts)``); with ``copy_input`` its input passes
    ``copy_to_group`` first. Parameters named as the Linear's."""

    def __init__(self, linear: nn.Linear, index: torch.Tensor, axis_name: str, copy_input: bool):
        super().__init__()
        with torch.no_grad():
            self.weight = nn.Parameter(linear.weight[index].clone())
            self.bias = None if linear.bias is None else nn.Parameter(linear.bias[index].clone())
        self.compute_dtype = getattr(linear, "compute_dtype", None)
        self.in_sizes = getattr(linear, "in_sizes", None)
        self.axis_name, self.copy_input = axis_name, copy_input

    def _in(self, x):
        return copy_to_group(x, self.axis_name) if self.copy_input else x

    def forward(self, x, posts=None):
        if self.in_sizes is None:
            return _linear(self._in(x), self.weight, self.bias, self.compute_dtype)
        dt = self.compute_dtype or self.weight.dtype  # SplitDense: one product per part
        out, off = None, 0
        for part, size, post in zip(x, self.in_sizes, posts):
            term = F.linear(self._in(part).to(dt), self.weight[:, off:off + size].to(dt))
            term = term if post is None else post(term)
            out = term if out is None else out + term
            off += size
        return out + self.bias.to(dt)


class RowParallelLinear(nn.Module):
    """This rank's input columns of a Linear: the partial product summed
    over the group (``reduce_from_group``), then the replicated bias."""

    def __init__(self, linear: nn.Linear, index: torch.Tensor, axis_name: str):
        super().__init__()
        with torch.no_grad():
            self.weight = nn.Parameter(linear.weight[:, index].clone())
        self.bias = linear.bias  # replicated: the same Parameter
        self.compute_dtype = getattr(linear, "compute_dtype", None)
        self.axis_name = axis_name

    def forward(self, x):
        dt = self.compute_dtype
        y = F.linear(x if dt is None else x.to(dt), self.weight if dt is None else self.weight.to(dt))
        y = reduce_from_group(y, self.axis_name)
        return y if self.bias is None else y + self.bias.to(y.dtype)


def _plans(model: nn.Module) -> List[_Plan]:
    """Every Linear the rule shards, in module order."""
    plans = []
    for module in model.modules():
        if isinstance(module, MLP):
            linears = [(name, m) for name, m in module.named_children() if isinstance(m, nn.Linear)]
            for i, (name, m) in enumerate(linears):
                kind = "column" if i % 2 == 0 else "row"
                plans.append(_Plan(module, name, m, kind, None, True))
        elif isinstance(module, Attention):
            for name in ("q_proj", "k_proj", "v_proj"):
                plans.append(_Plan(module, name, getattr(module, name), "column", module.num_heads,
                                   False))
            plans.append(_Plan(module, "proj", module.proj, "row", module.num_heads, False))
        elif isinstance(module, GatedMLPBlock):
            gated = module[1]
            for name in ("linear1", "linear2"):
                plans.append(_Plan(gated, name, getattr(gated, name), "column", None, False))
            plans.append(_Plan(module, "2", module[2], "row", None, False))
    return plans


def tp_param_specs(sim: nn.Module) -> Dict[str, Optional[TPSpec]]:
    """The rule for every parameter of ``sim`` (a full, unsharded
    simulator or model), by ``named_parameters`` name: its ``TPSpec``, or
    None where it is replicated."""
    names = {id(m): name for name, m in sim.named_modules()}
    specs: Dict[str, Optional[TPSpec]] = {name: None for name, _ in sim.named_parameters()}
    for plan in _plans(sim):
        prefix = names[id(plan.linear)]
        dim = 0 if plan.kind == "column" else 1
        specs[f"{prefix}.weight"] = TPSpec(plan.kind, dim, plan.heads)
        if plan.kind == "column" and plan.linear.bias is not None:
            specs[f"{prefix}.bias"] = TPSpec("column", 0, plan.heads)
    return specs


def shard_indices(width: int, size: int, rank: int, heads: Optional[int] = None) -> torch.Tensor:
    """The indices of rank ``rank`` of ``size`` along a sharded width: a
    contiguous block, or with ``heads`` the interleaved columns ``d * heads
    + h`` of its ``heads / size`` heads in ``(d, h_local)`` order."""
    if heads is None:
        step = width // size
        return torch.arange(rank * step, (rank + 1) * step)
    local = heads // size
    grid = torch.arange(width).reshape(width // heads, heads)
    return grid[:, rank * local:(rank + 1) * local].reshape(-1)


def check_tp_sizes(sim: nn.Module, size: int) -> None:
    """Raise unless ``size`` ranks divide every attention's heads and every
    sharded width of ``sim`` (a full simulator or model)."""
    plans = _plans(sim)
    for heads in {p.heads for p in plans if p.heads is not None}:
        if heads % size:
            raise ValueError(f"tensor parallelism: {size} ranks do not divide the {heads} "
                             f"attention heads (a rank holds whole heads)")
    for plan in plans:
        width = plan.linear.weight.shape[0 if plan.kind == "column" else 1]
        if width % size:
            raise ValueError(f"tensor parallelism: {size} ranks do not divide the width {width} of "
                             f"a {plan.kind}-parallel {type(plan.linear).__name__}")


def _move_state(optimizer, old: nn.Parameter, new: nn.Parameter, dim: int, index) -> None:
    """Put ``new`` in ``old``'s place in ``optimizer``, with the moments
    shaped as ``old`` cut the same way (``opt_state_specs``)."""
    for group in optimizer.param_groups:
        group["params"] = [new if p is old else p for p in group["params"]]
    state = optimizer.state.pop(old, None)
    if state is not None:
        optimizer.state[new] = {
            k: (v.index_select(dim, index.to(v.device))
                if torch.is_tensor(v) and v.shape == old.shape else v)
            for k, v in state.items()
        }


def _copy_first_input(axis_name, module, args):
    return (copy_to_group(args[0], axis_name),) + tuple(args[1:])


def shard_tp_state(sim: nn.Module, optimizer: Optional[torch.optim.Optimizer] = None,
                   axis_name: str = MODEL_AXIS) -> Dict[str, Optional[TPSpec]]:
    """Cut ``sim`` (a full simulator; every rank of ``axis_name``'s group
    calls this with the same weights) to this rank's slices in place, and
    the parameters and moments of ``optimizer`` with it. The inputs that
    several column-parallel Linears share (an ``Attention``'s, a
    ``GatedMLP``'s) pass ``copy_to_group`` once, a ``GraphNetBlock``'s edge
    MLP's before its gathers (``GraphNetBlock.input_copy``). Returns the specs
    (``tp_param_specs``). Raises where the group's size does not divide a
    sharded width or the heads."""
    size, rank = axis_size(axis_name), axis_rank(axis_name)
    specs = tp_param_specs(sim)
    check_tp_sizes(sim, size)
    plans = _plans(sim)
    hook = functools.partial(_copy_first_input, axis_name)
    for plan in plans:
        width = plan.linear.weight.shape[0 if plan.kind == "column" else 1]
        index = shard_indices(width, size, rank, plan.heads).to(plan.linear.weight.device)
        if plan.kind == "column":
            new = ColumnParallelLinear(plan.linear, index, axis_name, plan.copy_input)
            pairs = [(plan.linear.weight, new.weight), (plan.linear.bias, new.bias)]
        else:
            new = RowParallelLinear(plan.linear, index, axis_name)
            pairs = [(plan.linear.weight, new.weight)]
        if optimizer is not None:
            for old, fresh in pairs:
                if old is not None:
                    _move_state(optimizer, old, fresh, 0 if plan.kind == "column" else 1, index)
        setattr(plan.parent, plan.attr, new)
    for module in sim.modules():
        if isinstance(module, GraphNetBlock) and not module.project_before_gather:
            # the edge MLP's gradient all-reduce on its node and edge inputs
            # before the gathers: 2 tables of N and E rows, not one of E
            # rows three tables wide
            module.edge_block[0].copy_input = False
            module.input_copy = functools.partial(copy_to_group, axis_name=axis_name)
        elif isinstance(module, Attention):
            module.num_heads //= size  # the local heads; the scale keeps the model's
            module.register_forward_pre_hook(hook)
        elif isinstance(module, GatedMLP):
            module.register_forward_pre_hook(hook)
    sim.tp_axis = axis_name
    sim.tp_specs = specs
    return specs


def _full(local: torch.Tensor, spec: TPSpec, axis_name: str) -> torch.Tensor:
    """The whole tensor of the ranks' slices ``local`` along ``spec.dim``."""
    group = graph_group(axis_name)
    size = dist.get_world_size(group)
    moved = local.movedim(spec.dim, 0).contiguous()
    table = moved.new_empty((size * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(table, moved, group=group)
    width = table.shape[0]
    order = torch.cat([shard_indices(width, size, r, spec.heads) for r in range(size)])
    full = torch.empty_like(table)
    full[order.to(table.device)] = table
    return full.movedim(0, spec.dim)


def gather_tp_state_dict(sim: nn.Module, grads: bool = False) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` of a sharded simulator (``shard_tp_state``)
    under the reference names, on every rank (every rank of the group calls
    it at once); with ``grads``, the full gradients of its parameters
    instead (zeros where there is none)."""
    if grads:
        tensors = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                   for n, p in sim.named_parameters()}
    else:
        tensors = {n: t.detach() for n, t in sim.state_dict().items()}
    out = {}
    for name, t in tensors.items():
        spec = sim.tp_specs.get(name)
        out[name] = t.clone() if spec is None else _full(t, spec, sim.tp_axis)
    return out


def make_tp_train_step(
    sim: nn.Module,
    optimizer: torch.optim.Optimizer,
    masks: Sequence[int],
    axis_name: str = MODEL_AXIS,
    loss_kind: str = "l2",
    gmm_kwargs: Optional[dict] = None,
) -> Callable:
    """``step(graph)``: one optimizer step of the sharded ``sim``
    (``shard_tp_state`` first, with this optimizer) on a replicated graph,
    every rank of the group calling it at once with the same graph. The
    loss is the single-device step's (the masked mean over the graph);
    returns it, a 0-d tensor on the device, on every rank. An
    edge-partitioned part is refused: its exchanges would bypass the first
    edge layer's input copy."""
    if getattr(sim, "tp_axis", None) != axis_name:
        raise ValueError(f"make_tp_train_step: shard the simulator over '{axis_name}' first "
                         f"(shard_tp_state)")
    local_loss = make_local_loss(list(masks), loss_kind, gmm_kwargs or {})
    device = next(sim.parameters()).device

    def step(graph) -> torch.Tensor:
        if graph.partition_axis is not None:
            raise ValueError("tensor-parallel step: the graph must be replicated, not an "
                             "edge-partitioned part")
        graph = graph.to(device)
        out, target, _ = sim(graph, is_training=True)
        loss_sum, count = local_loss(target, out, sim.node_type(graph), graph.node_mask,
                                     graph.exclude_mask)
        loss = loss_sum / torch.clamp(count, min=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step

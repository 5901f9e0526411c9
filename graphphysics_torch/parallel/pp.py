"""Pipeline parallelism over the message-passing depth, GPipe on a ring of
the pipe group's ``S`` ranks (counterpart of
``graphphysics_tpu/parallel/pp.py``).

Stage ``s`` holds the blocks ``processor_list[s*K:(s+1)*K]`` (``K = L /
S``; ``shard_pp_state``). The JAX package gets the stages from the
``scan_blocks`` layout (stacked ``[L, ...]`` kernels, sharded on the layer
axis); the port runs its blocks unrolled, and a JAX ``scan_blocks`` model's
weights map through ``utils.reference_weights.unstack_scanned_blocks``. As
in JAX, ``make_pp_train_step`` needs ``scan_blocks`` set and refuses
``remat``, ``only_processor``, an EPD without edge features and ``L`` not
divisible by ``S``.

A step takes ``M`` microbatches stacked ``[M, ...]`` in the model's own
layout (receiver-sorted for the EPD, CSR for the transformer; not COO as in
JAX) and runs the GPipe schedule of ``M + S - 1`` ticks on every rank in
the same order, so that the collectives pair: at tick ``t`` stage ``s``
runs its blocks on microbatch ``t - s`` when there is one, and every rank
then shifts its node table (and the EPD's edge table) one stage round the
ring (``ring_shift``: an autograd function whose forward sends to ``s +
1`` and whose backward sends the gradient back to ``s - 1``, one
``all_to_all_single`` each, which gloo carries on CUDA tensors). JAX runs
each stage's blocks on every tick and masks the idle ones; the port skips
them, so a stage launches its blocks' kernels ``K * M`` times a step, not
``K * (M + S - 1)``, and an idle tick passes the table it received on.
Stage 0 takes the encoders' output and ties the ring's wrap-around into
its graph with a zero gradient, so every shift has a backward on every
rank and the backward shifts pair in reverse tick order.

The normalizers fold all ``M`` microbatches in once (one accumulation
over their rows) on every rank. Stage 0 alone runs the encoders, the last
stage the decoder and the loss: the masked mean over every microbatch's
rows, the single-device step's on their concatenation. Encoder, decoder
and norm gradients are summed over the group (one ``all_reduce``, with the
loss), so the replicated parameters stay equal; block gradients stay on
their stage. The models: EPD and the transformer, with the plain decoder
or either GMM head (its NLL).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from graphphysics_torch.core.graph import Graph, flatten_batched_graph
from graphphysics_torch.parallel.mesh import PIPE_AXIS, axis_rank, axis_size, graph_group
from graphphysics_torch.training.losses import make_local_loss

BLOCKS = "model.processor_list."
# the ring's shifts, forward and backward: one a table, and the bytes each
# rank sends
SHIFTS = {"calls": 0, "bytes": 0}


class PPStage(NamedTuple):
    """This rank's stage: the pipe axis, the stages ``S``, this stage
    ``s`` and its ``K`` blocks (global indices ``s*K .. (s+1)*K - 1``)."""

    axis_name: str
    stages: int
    stage: int
    blocks: int


def check_pp_model(sim, stages: int) -> None:
    """Raise what the JAX step refuses: a model other than the EPD or the
    transformer, no ``scan_blocks``, ``only_processor``, ``remat``, an EPD
    without edge features, ``L`` not divisible by ``stages``."""
    from graphphysics_torch.models.processors import EncodeProcessDecode, EncodeTransformDecode

    model = sim.model
    if not isinstance(model, (EncodeProcessDecode, EncodeTransformDecode)):
        raise NotImplementedError("pipeline parallelism supports EPD/transformer")
    if not model.scan_blocks:
        raise ValueError("make_pp_train_step needs scan_blocks=True (in JAX the stacked [L] block "
                         "params' layer axis is the pipe shard axis)")
    if getattr(model, "only_processor", False):
        raise NotImplementedError("pp: only_processor models not supported")
    if model.remat:
        raise NotImplementedError("pp: remat not supported (the GPipe schedule already bounds "
                                  "live activations to one microbatch per stage)")
    if isinstance(model, EncodeProcessDecode) and sim.config.edge_input_size <= 0:
        raise ValueError("pp: EPD requires edge features (edge_input_size > 0)")
    blocks = getattr(sim, "pp_stage", None)
    total = len(model.processor_list) * (blocks.stages if blocks else 1)
    if total % stages:
        raise ValueError(f"message_passing_num {total} not divisible by pipe size {stages}")


def shard_pp_state(sim, optimizer: Optional[torch.optim.Optimizer] = None,
                   axis_name: str = PIPE_AXIS) -> PPStage:
    """Keep this stage's blocks of ``sim`` (every rank of ``axis_name``'s
    group calls this with the same full model) and drop the others, from
    the optimizer too with their moments. Returns the stage."""
    stages, stage = axis_size(axis_name), axis_rank(axis_name)
    check_pp_model(sim, stages)
    blocks = sim.model.processor_list
    k = len(blocks) // stages
    keep = list(blocks[stage * k:(stage + 1) * k])
    if optimizer is not None:
        kept = {id(p) for b in keep for p in b.parameters()}
        dropped = {id(p) for p in blocks.parameters()} - kept
        for group in optimizer.param_groups:
            group["params"] = [p for p in group["params"] if id(p) not in dropped]
        for p in [p for p in optimizer.state if id(p) in dropped]:
            del optimizer.state[p]
    sim.model.processor_list = nn.ModuleList(keep)
    sim.pp_stage = PPStage(axis_name, stages, stage, k)
    return sim.pp_stage


def _global_name(name: str, stage: PPStage) -> str:
    if not name.startswith(BLOCKS):
        return name
    index, rest = name[len(BLOCKS):].split(".", 1)
    return f"{BLOCKS}{stage.stage * stage.blocks + int(index)}.{rest}"


def gather_pp_state_dict(sim, grads: bool = False) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` of a staged simulator (``shard_pp_state``)
    under the reference names, on the CPU, on every rank (every rank of
    the group calls it at once); with ``grads``, the full gradients of its
    parameters instead (zeros where there is none)."""
    stage = sim.pp_stage
    if grads:
        local = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in
                 sim.named_parameters()}
    else:
        local = sim.state_dict()
    local = {_global_name(n, stage): t.detach().to("cpu", copy=True) for n, t in local.items()}
    own = {n: t for n, t in local.items() if n.startswith(BLOCKS)}
    every = [None] * stage.stages
    dist.all_gather_object(every, own, group=graph_group(stage.axis_name))
    out = {n: t for n, t in local.items() if not n.startswith(BLOCKS)}
    for blocks in every:
        out.update(blocks)
    return out


def _shift(t: torch.Tensor, forward: bool, axis_name: str) -> torch.Tensor:
    """``t``'s rows to the next stage (``forward``) or the previous one,
    and the rows the other neighbour sent: one ``all_to_all_single``."""
    group = graph_group(axis_name)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    to, frm = ((rank + 1) % size, (rank - 1) % size) if forward else ((rank - 1) % size,
                                                                    (rank + 1) % size)
    n = t.shape[0]
    send = [n if r == to else 0 for r in range(size)]
    recv = [n if r == frm else 0 for r in range(size)]
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), recv, send, group=group)
    SHIFTS["calls"] += 1
    SHIFTS["bytes"] += t.numel() * t.element_size()
    return out


class _RingShift(torch.autograd.Function):
    """The tables to stage ``s + 1``; the gradients back to ``s - 1``. The
    ``anchor`` (a scalar that requires grad) records the node even when a
    table carries no gradient, so every rank runs every backward shift."""

    @staticmethod
    def forward(ctx, anchor, axis_name, *tables):
        ctx.axis_name = axis_name
        return tuple(_shift(t, True, axis_name) for t in tables)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_shift(g, False, ctx.axis_name) for g in grads)


def ring_shift(tables, anchor: torch.Tensor, axis_name: str = PIPE_AXIS) -> tuple:
    """Every rank's ``tables`` one stage round the ring of ``axis_name``'s
    group, differentiably."""
    return _RingShift.apply(anchor, axis_name, *tables)


class _Tie(torch.autograd.Function):
    """``a`` as it is, with ``others`` in its graph: their gradient is 0."""

    @staticmethod
    def forward(ctx, a, *others):
        ctx.like = [(o.shape, o.dtype, o.device) for o in others]
        return a.view_as(a)

    @staticmethod
    def backward(ctx, g):
        return (g,) + tuple(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.like)


def _loss_of(sim, masks):
    """The model's own loss: the masked L2, or its GMM head's NLL at the
    model's temperature (None reads as 1.0), as the single-device step."""
    from graphphysics_torch.training.microbatch import gmm_kwargs, loss_kind

    model = sim.model
    k = model.num_mixture_components
    t = 1.0 if model.temperature is None else model.temperature
    return make_local_loss(list(masks), loss_kind(k, model.use_diagonal),
                           gmm_kwargs(k, sim.config.output_size, t))


def check_microbatches(mbs: Graph) -> None:
    """Raise on partitioned, halo or ELL microbatches (the stages run the
    plain layouts)."""
    if mbs.partition_axis is not None or mbs.halo_send_idx is not None or mbs.ell_degree is not None:
        raise ValueError("pp: microbatches must be plain unpartitioned graphs in the model's "
                         "layout (got partition_axis/halo_send_idx/ell_degree set)")


def make_pp_train_step(sim, optimizer: torch.optim.Optimizer, masks: Sequence[int],
                       axis_name: str = PIPE_AXIS) -> Callable[[Graph], torch.Tensor]:
    """``step(microbatches)``: one GPipe optimizer step of the staged
    ``sim`` (``shard_pp_state`` first, with this optimizer) over ``M``
    microbatches stacked ``[M, ...]`` (``core.graph.stack_graphs``), every
    rank of the group calling it at once with the same microbatches. Equal
    to the single-device step on their concatenation (masked global mean
    loss, one normalizer accumulation of all rows). Returns the loss, a
    0-d tensor on the device, on every rank."""
    stage = getattr(sim, "pp_stage", None)
    if stage is None or stage.axis_name != axis_name:
        raise ValueError(f"make_pp_train_step: stage the simulator over '{axis_name}' first "
                         f"(shard_pp_state)")
    stages = stage.stages
    check_pp_model(sim, stages)
    model, s = sim.model, stage.stage
    first, last = s == 0, s == stages - 1
    epd = sim._edge_normalizer is not None
    local_loss = _loss_of(sim, masks)
    replicated = [p for n, p in sim.named_parameters() if not n.startswith(BLOCKS)]
    device = replicated[0].device
    anchor = torch.zeros((), device=device, requires_grad=True)
    hidden = model.nodes_encoder[-2].out_features

    def encode(g: Graph):
        x = model.nodes_encoder(sim._node_normalizer(sim._build_node_features(g)))
        e = model.edges_encoder(sim._edge_normalizer(g.edge_attr)) if epd else None
        return x, e

    def step(mbs: Graph) -> torch.Tensor:
        check_microbatches(mbs)
        mbs = mbs.to(device)
        m = mbs.x.shape[0]
        flat = flatten_batched_graph(mbs)
        sim.accumulate_stats(flat)  # once over the M microbatches' rows
        graphs = [mbs[i] for i in range(m)]
        outs = [None] * m
        carry = None
        for t in range(m + stages - 1):
            mb = t - s
            if 0 <= mb < m:
                if first:
                    x, e = encode(graphs[mb])
                    if carry is not None:  # the ring's wrap-around: gradient 0
                        x = _Tie.apply(x, *carry)
                else:
                    x, e = carry if epd else (carry[0], None)
                x, e = model.process(x, e, graphs[mb], model.processor_list)
                if last:
                    outs[mb] = x
                send = (x, e) if epd else (x,)
            elif carry is not None:
                send = carry
            else:  # before the first microbatch reaches this stage
                n, edges = mbs.x.shape[1], mbs.senders.shape[1]
                send = (torch.zeros(n, hidden, device=device),)
                if epd:
                    send += (torch.zeros(edges, hidden, device=device),)
            carry = ring_shift(send, anchor, axis_name)
        if last:
            target = sim._output_normalizer(flat.y - sim._pre_target(flat))
            out = torch.cat([model.decode_module(o).to(torch.float32) for o in outs])
            loss_sum, count = local_loss(target, out, sim.node_type(flat), flat.node_mask,
                                         flat.exclude_mask)
            loss = loss_sum / torch.clamp(count, min=1.0)
        else:
            loss = anchor * 0.0
        optimizer.zero_grad(set_to_none=True)
        _Tie.apply(loss, *carry).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in replicated]
        flat_grads = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        dist.all_reduce(flat_grads, group=graph_group(axis_name))
        off = 0
        with torch.no_grad():
            for p in replicated:
                p.grad = flat_grads[off:off + p.numel()].reshape(p.shape).to(p.dtype)
                off += p.numel()
        optimizer.step()
        return flat_grads[-1]

    return step

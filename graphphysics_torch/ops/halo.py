"""The exchanges of edge-partitioned graphs (counterpart of
``graphphysics_tpu/ops/halo.py``).

Each rank of the graph group (``parallel.mesh``) owns ``Nl`` contiguous node
rows. Per message-passing layer the sender rows an edge reads cross ranks
one of two ways:

- halo mode (``Graph.halo_send_idx`` ``[P, B]``: the local rows this rank
  sends to each peer): one ``all_to_all_single`` of ``P * B`` rows, and the
  edges' senders index the exchange table ``[local rows | received rows]``,
  where the row peer ``q`` sent at request slot ``r`` sits at
  ``Nl + q * B + r``;
- gather mode: an all-gather of every rank's rows, the senders global ids.

Both are linear maps with autograd backwards: the halo exchange's backward
is the same ``all_to_all_single`` of the received rows' cotangent followed
by the sum into the sent rows (the gather's backward); the all-gather's is
a reduce-scatter of the table's cotangent. ``wire_dtype`` "bf16" / "f16"
ships the halo rows in 16 bits, rounded once each way, the cotangent too.

``halo_recv(..., async_op=True)`` starts the exchange and returns a handle
whose ``wait()`` gives the received rows: a caller can compute what does
not need them (the local partial of split-edge attention, the local part
of an edge MLP) before it waits, the counterpart of the JAX package
leaving that overlap to XLA's scheduler.

Collectives on gloo: ranks that share a card run gloo, and the tensors go
to it as they are, CUDA or CPU, f32 or bf16, as to NCCL, with no staging in
this module: ``chip_smoke.py``'s partitioned phases run all_to_all_single
(sync and async), all_gather_into_tensor and all_reduce so on an H100; the
gather mode's reduce_scatter_tensor runs on the CPU's gloo in the tests.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from graphphysics_torch.ops.segment import take_rows


def graph_group(axis_name: str):
    """``parallel.mesh.graph_group`` (imported at the call: ``parallel``
    imports the models' ops)."""
    from graphphysics_torch.parallel.mesh import graph_group as group

    return group(axis_name)

WIRE_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16}


class Pending:
    """An exchange in flight: ``wait()`` returns the received tensor on the
    sender's device."""

    def __init__(self, work, recv: torch.Tensor):
        self._work, self._recv = work, recv

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            # a profiler range, so a trace shows how long a rank waits here
            with torch.profiler.record_function("halo.wait"):
                self._work.wait()
        return self._recv


def all_to_all(send: torch.Tensor, axis_name: str, async_op: bool = False) -> Pending:
    """``all_to_all_single`` over the graph group of ``axis_name``: the
    ``P`` equal row blocks of ``send`` go one to each rank, block ``q`` of
    the result came from rank ``q``."""
    send = send.contiguous()
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=graph_group(axis_name), async_op=async_op)
    return Pending(work, recv)


# the exchange primitive: tests put a recording stand-in here
exchange = all_to_all


class _Exchange(torch.autograd.Function):
    """The received rows of an exchange started on ``send``: the forward
    waits for it, the backward exchanges the cotangent back."""

    @staticmethod
    def forward(ctx, send, pending, axis_name):
        ctx.axis_name = axis_name
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        return exchange(g.contiguous(), ctx.axis_name).wait(), None, None


class HaloHandle:
    """The halo rows of ``halo_recv(..., async_op=True)`` in flight."""

    def __init__(self, send, pending, axis_name, dtype, rows):
        self._send, self._pending, self._axis = send, pending, axis_name
        self._dtype, self._rows = dtype, rows

    def wait(self) -> torch.Tensor:
        recv = _Exchange.apply(self._send, self._pending, self._axis)
        return recv.to(self._dtype).reshape(self._rows, -1)


def halo_recv(
    x: torch.Tensor,
    halo_send_idx: torch.Tensor,
    axis_name: str,
    wire_dtype: Optional[str] = None,
    async_op: bool = False,
):
    """The ``[P * B, F]`` halo rows received from each peer (peer-major,
    request-slot-minor), in ``x``'s dtype: this rank sends
    ``x[halo_send_idx[q]]`` to peer ``q``. ``wire_dtype`` "bf16"/"f16"
    ships them in 16 bits (None: ``x``'s dtype). With ``async_op`` returns
    a ``HaloHandle`` whose ``wait()`` gives them."""
    p, b = halo_send_idx.shape
    send = take_rows(x, halo_send_idx.reshape(-1))  # [P*B, F]
    wire = WIRE_DTYPES.get(wire_dtype) if wire_dtype else None
    if wire is not None and send.dtype != wire:
        send = send.to(wire)
    handle = HaloHandle(send, exchange(send.detach(), axis_name, async_op=async_op), axis_name,
                        x.dtype, p * b)
    return handle if async_op else handle.wait()


def halo_table(x: torch.Tensor, halo_send_idx: torch.Tensor, axis_name: str,
               wire_dtype: Optional[str] = None) -> torch.Tensor:
    """The exchange table ``[Nl + P * B, F]``: the local rows, then the
    received halo rows (``halo_recv``)."""
    return torch.cat([x, halo_recv(x, halo_send_idx, axis_name, wire_dtype)], dim=0)


class _AllGather(torch.autograd.Function):
    """Every rank's ``[Nl, F]`` rows as one ``[P * Nl, F]`` table; the
    backward sums the table's cotangent over the ranks and keeps this
    rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis_name):
        group = graph_group(axis_name)
        ctx.axis_name = axis_name
        x = x.contiguous()
        table = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(table, x, group=group)
        return table

    @staticmethod
    def backward(ctx, g):
        group = graph_group(ctx.axis_name)
        rows = g.shape[0] // dist.get_world_size(group)
        out = g.new_empty((rows,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=group)
        return out, None


def all_gather_table(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Every rank's rows, rank-major: the gather mode's table."""
    return _AllGather.apply(x, axis_name)


def partitioned_gather(
    x: torch.Tensor,
    senders: torch.Tensor,
    axis_name: str,
    halo_send_idx: Optional[torch.Tensor] = None,
    halo_dtype: Optional[str] = None,
) -> torch.Tensor:
    """Sender rows of an edge-partitioned graph: from the all-gathered
    table (``senders`` global ids) without ``halo_send_idx``, from the halo
    exchange table (``senders`` table rows, shipped in ``halo_dtype``)
    with it."""
    if halo_send_idx is None:
        table = all_gather_table(x, axis_name)
    else:
        table = halo_table(x, halo_send_idx, axis_name, halo_dtype)
    return take_rows(table, senders)

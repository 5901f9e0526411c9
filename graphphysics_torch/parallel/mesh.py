"""The process groups of the data and graph axes (counterpart of
``graphphysics_tpu/parallel/mesh.py``'s ``DATA_AXIS`` and ``GRAPH_AXIS``).

The JAX package runs data parallelism and the ``P`` parts of a partitioned
graph as the devices of a ``shard_map`` mesh. The port runs each device as
one ``torch.distributed`` rank: a device on the graph axis is a rank of a
graph group, one part each (a partitioned graph names its group in
``Graph.partition_axis`` and the model's exchanges look the group up here,
``graph_group``), a device on the data axis a rank of a data group.

A world of ``R = D x P`` ranks is laid out as the JAX ``(data, graph)``
mesh of shape ``(D, P)``: rank ``r`` is data row ``r // P`` and graph
column ``r % P``. The ``D`` graph groups are the rows (the ``P`` parts of
one graph), the ``P`` data groups the columns (one rank of each row);
``init_layout`` makes them, in the same order on every rank, and registers
the rank's own under ``GRAPH_AXIS`` and ``DATA_AXIS``. A reduction over both
axes is one over the world (``axis_group((DATA_AXIS, GRAPH_AXIS))``). The
1-D data-parallel world is ``D = R, P = 1``; an edge-partitioned one
``D = 1, P = R``.

The backend follows from where the ranks sit: one rank per card is NCCL;
ranks that share a card, or run on the CPU, are gloo (NCCL refuses two
ranks on one device). Nothing switches the backend because something
failed.

``launch(fn, num_ranks, device, layout=(D, P))`` starts the ranks as spawned processes,
each joined to the group through a ``FileStore`` in a fresh temporary
directory (no TCP port to race for), runs ``fn(rank, *args)`` in each and
returns their results in rank order; any rank's failure, or the timeout,
stops them all and raises. Under ``torchrun`` (``WORLD_SIZE`` ranks
already started) ``init_from_env`` joins instead. Without a layout the
world is one graph group, as edge partitioning alone needs.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from graphphysics_torch.core.device import DeviceLike, resolve_device

GRAPH_AXIS = "graph"
DATA_AXIS = "data"
LAUNCH_TIMEOUT_S = 900.0

_GROUPS: Dict[str, Any] = {}


def rank_device(device: DeviceLike, rank: int, num_ranks: int) -> torch.device:
    """The device of rank ``rank`` of a world of ``num_ranks``: the CPU,
    card ``rank`` when there is a card per rank, else the one card all
    ranks share."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if torch.cuda.device_count() >= num_ranks:
        return torch.device("cuda", rank)
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def backend_for(device: DeviceLike, num_ranks: int) -> str:
    """``nccl`` when each of the world's ``num_ranks`` ranks has a card of
    its own, ``gloo`` when the ranks share a card or run on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= num_ranks:
        return "nccl"
    return "gloo"


def register_group(group: Any = None, axis_name: str = GRAPH_AXIS) -> None:
    """Make ``group`` (the default group when None) the process group of
    ``axis_name``."""
    _GROUPS[axis_name] = dist.group.WORLD if group is None else group


def graph_group(axis_name: str = GRAPH_AXIS):
    """The process group of a partitioned graph's ``partition_axis`` (of
    any registered axis)."""
    group = _GROUPS.get(axis_name)
    if group is None:
        raise RuntimeError(
            f"no process group for partition axis {axis_name!r}: start the ranks with "
            f"parallel.mesh.launch, or join with init_graph_group / init_from_env"
        )
    return group


def axis_group(axes):
    """The group of one axis name, or of a tuple of names: one name's
    group, or the world for both axes of the layout."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(names) == 1:
        return graph_group(names[0])
    for name in names:
        graph_group(name)  # each must be registered
    return dist.group.WORLD


def graph_rank(axis_name: str = GRAPH_AXIS) -> int:
    """This rank's place in its graph group: the index of its part."""
    return dist.get_rank(graph_group(axis_name))


def graph_size(axis_name: str = GRAPH_AXIS) -> int:
    """The ranks of this rank's graph group: the parts of one graph."""
    return dist.get_world_size(graph_group(axis_name))


def data_rank(axis_name: str = DATA_AXIS) -> int:
    """This rank's place in its data group: its data row."""
    return dist.get_rank(graph_group(axis_name))


def data_size(axis_name: str = DATA_AXIS) -> int:
    """The ranks of this rank's data group: the data rows."""
    return dist.get_world_size(graph_group(axis_name))


def init_layout(data: int, parts: int) -> None:
    """Lay the initialized world out as ``data`` rows of ``parts`` ranks
    (``data * parts`` must be the world size): make the ``data`` graph
    groups (rows) and the ``parts`` data groups (columns), in the same
    order on every rank (every rank must call this at once), and register
    this rank's own under ``GRAPH_AXIS`` and ``DATA_AXIS``. An axis that
    spans the world is the world group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * parts != world:
        raise ValueError(f"layout {data} x {parts} does not cover the world's {world} ranks")
    rows = [list(range(d * parts, (d + 1) * parts)) for d in range(data)]
    columns = [list(range(p, world, parts)) for p in range(parts)]
    for axis, groups in ((GRAPH_AXIS, rows), (DATA_AXIS, columns)):
        if len(groups) == 1:
            register_group(None, axis)
            continue
        for members in groups:
            group = dist.new_group(members)
            if rank in members:
                register_group(group, axis)


def group_backend(axis_name: str = GRAPH_AXIS) -> str:
    return str(dist.get_backend(graph_group(axis_name)))


def ensure_layout(data: int, parts: int) -> None:
    """``init_layout(data, parts)`` unless this rank's registered data and
    graph groups already have those sizes (every rank must call it at
    once)."""
    try:
        if data_size() == data and graph_size() == parts:
            return
    except RuntimeError:  # an axis not registered yet
        pass
    init_layout(data, parts)


def _register(axis_name: str, layout: Optional[Sequence[int]]) -> None:
    if layout is None:
        register_group(None, axis_name)
    else:
        init_layout(*layout)


def init_graph_group(rank: int, num_parts: int, device: DeviceLike, store_path: str,
                     axis_name: str = GRAPH_AXIS, layout: Optional[Sequence[int]] = None) -> str:
    """Join rank ``rank`` of a world of ``num_parts`` through the
    ``FileStore`` at ``store_path``, register the world as ``axis_name``'s
    group (with ``layout`` ``(D, P)``, the groups of ``init_layout``
    instead) and return the backend."""
    backend = backend_for(device, num_parts)
    dev = rank_device(device, rank, num_parts)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, num_parts)
    dist.init_process_group(backend, store=store, rank=rank, world_size=num_parts)
    _register(axis_name, layout)
    return backend


def init_from_env(num_parts: int, device: DeviceLike, axis_name: str = GRAPH_AXIS,
                  layout: Optional[Sequence[int]] = None) -> int:
    """Join a group ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in the environment); its world size
    must be ``num_parts``. Registers as ``init_graph_group`` does and
    returns this process's rank."""
    world = int(os.environ["WORLD_SIZE"])
    if world != num_parts:
        raise ValueError(f"WORLD_SIZE {world} != the {num_parts} ranks asked for")
    rank = int(os.environ["RANK"])
    dev = rank_device(device, rank, num_parts)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(device, num_parts), init_method="env://")
    _register(axis_name, layout)
    return rank


def under_torchrun(num_parts: int) -> bool:
    """True in a process ``torchrun`` started with ``num_parts`` ranks."""
    return os.environ.get("WORLD_SIZE") == str(num_parts) and "RANK" in os.environ


def _rank_main(rank, fn, args, num_parts, device, store_path, axis_name, threads, layout, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_graph_group(rank, num_parts, device, store_path, axis_name, layout)
        try:
            value = fn(rank, *args)
        finally:
            dist.destroy_process_group()
            _GROUPS.clear()
        results.put((rank, True, value))
    except BaseException:  # the parent reports it and stops the others
        results.put((rank, False, traceback.format_exc()))


def launch(
    fn: Callable,
    num_parts: int,
    device: DeviceLike = None,
    args: Sequence[Any] = (),
    timeout: Optional[float] = LAUNCH_TIMEOUT_S,
    axis_name: str = GRAPH_AXIS,
    threads: Optional[int] = None,
    layout: Optional[Sequence[int]] = None,
) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``num_parts`` spawned ranks on ``device``
    (``cuda`` unless named; see ``rank_device``), one graph group or, with
    ``layout`` ``(D, P)``, the groups of ``init_layout``, and return the
    results in rank order. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function); ``threads`` sets each rank's intra-op
    threads. Raises with the rank's traceback when one fails, and
    after ``timeout`` seconds (None: no limit, for a training run); every
    rank is stopped before it returns or raises."""
    resolve_device(device)  # a CUDA device without a card raises here
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="graph_group_")
    store_path = os.path.join(tmp, "store")
    dev_name = str(resolve_device(device))
    procs = [
        ctx.Process(target=_rank_main,
                    args=(r, fn, tuple(args), num_parts, dev_name, store_path, axis_name, threads,
                          None if layout is None else tuple(layout), results))
        for r in range(num_parts)
    ]
    try:
        for p in procs:
            p.start()
        out: Dict[int, Any] = {}
        deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
        while len(out) < num_parts:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"launch: {num_parts} ranks did not finish within {timeout:.0f} s "
                                   f"(finished: {sorted(out)})")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"launch: rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} without a result")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=min(max(deadline - time.monotonic(), 1.0), 60.0))
        return [out[r] for r in range(num_parts)]
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)

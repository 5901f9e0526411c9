"""The process groups of the mesh axes (counterpart of
``graphphysics_tpu/parallel/mesh.py``'s ``DATA_AXIS``, ``GRAPH_AXIS``,
``make_mesh`` and ``make_hybrid_mesh``, and of ``MODEL_AXIS`` and
``PIPE_AXIS`` in its ``tp.py`` and ``pp.py``).

The JAX package runs data, graph, tensor and pipeline parallelism as the
devices of a named mesh. The port runs each device as one
``torch.distributed`` rank: a device on the graph axis is a rank of a graph
group, one part each (a partitioned graph names its group in
``Graph.partition_axis`` and the model's exchanges look the group up here,
``graph_group``), a device on the data axis a rank of a data group, one on
the model axis a rank of a tensor-parallel group (``parallel.tp``), one on
the pipe axis a stage of a pipeline (``parallel.pp``).

A world of ranks is laid out as a named grid (``Layout``), the counterpart
of a JAX mesh: ``make_layout(axis_names, shape)`` puts the ranks in
row-major order, as ``make_mesh`` puts the devices, and
``make_hybrid_layout`` factors each axis into a part across hosts and a
part within one (``make_hybrid_mesh``). Along each axis the grid's lines
are that axis's groups; ``init_layout`` makes them, in the same order on
every rank, and registers the rank's own under the axis name. The 2-axis
``init_layout(D, P)`` is the ``(data, graph)`` grid of shape ``(D, P)``:
rank ``r`` is data row ``r // P`` and graph column ``r % P``. A reduction
over every axis of the layout is one over the world
(``axis_group((DATA_AXIS, GRAPH_AXIS))``). The 1-D data-parallel world is
``D = R, P = 1``; an edge-partitioned one ``D = 1, P = R``.

The backend follows from where the ranks sit: one rank per card is NCCL;
ranks that share a card, or run on the CPU, are gloo (NCCL refuses two
ranks on one device). Nothing switches the backend because something
failed.

``launch(fn, num_ranks, device, layout=...)`` starts the ranks as spawned
processes, each joined to the group through a ``FileStore`` in a fresh
temporary directory (no TCP port to race for), runs ``fn(rank, *args)`` in
each and returns their results in rank order; any rank's failure, or the
timeout, stops them all and raises. ``layout`` is a ``Layout`` or a
``(D, P)`` pair. Under ``torchrun`` (``WORLD_SIZE`` ranks already started)
``init_from_env`` joins instead. Without a layout the world is one group of
``axis_name`` (the graph axis unless named), as edge partitioning alone
needs.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from graphphysics_torch.core.device import DeviceLike, resolve_device

GRAPH_AXIS = "graph"
DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
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
    group, or the world for every axis of the layout (a tuple of axes that
    spans fewer ranks raises)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(names) == 1:
        return graph_group(names[0])
    spanned = int(np.prod([dist.get_world_size(graph_group(n)) for n in names]))
    if spanned != dist.get_world_size():
        raise ValueError(f"axes {names} span {spanned} of the world's {dist.get_world_size()} ranks: "
                         f"a reduction over several axes must cover the whole layout")
    return dist.group.WORLD


def axis_rank(axis_name: str) -> int:
    """This rank's place along ``axis_name``: its index in that axis's
    group."""
    return dist.get_rank(graph_group(axis_name))


def axis_size(axis_name: str) -> int:
    """The ranks along ``axis_name``: the size of its groups."""
    return dist.get_world_size(graph_group(axis_name))


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


class Layout(NamedTuple):
    """A named grid of ranks, the counterpart of a JAX ``Mesh``:
    ``grid[i0, i1, ...]`` is the world rank at those positions along
    ``axis_names``."""

    axis_names: tuple
    grid: np.ndarray

    @property
    def shape(self) -> tuple:
        return tuple(self.grid.shape)


def make_layout(axis_names: Sequence[str] = (DATA_AXIS,), shape: Optional[Sequence[int]] = None,
                world_size: Optional[int] = None) -> Layout:
    """The ranks of a world of ``world_size`` (default: the initialized
    world's) in row-major order on a grid of ``shape`` (default: every rank
    on the first axis), as ``make_mesh`` lays out devices."""
    world = dist.get_world_size() if world_size is None else int(world_size)
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"layout shape {tuple(shape)} does not name its {len(axis_names)} axes")
    if int(np.prod(shape)) != world:
        raise ValueError(f"layout {tuple(shape)} does not cover the world's {world} ranks")
    return Layout(tuple(axis_names), np.arange(world).reshape(tuple(int(n) for n in shape)))


def make_hybrid_layout(
    axis_names: Sequence[str] = (DATA_AXIS, GRAPH_AXIS),
    dcn_shape: Optional[Sequence[int]] = None,
    ici_shape: Optional[Sequence[int]] = None,
    world_size: Optional[int] = None,
) -> Layout:
    """The multi-host layout (``make_hybrid_mesh``): each axis's size
    factors into ``dcn_shape[i]`` across hosts and ``ici_shape[i]`` within
    one, so that an axis with ``dcn_shape[i] == 1`` never leaves a host.
    A host is a slice: ``torchrun`` gives each host a contiguous block of
    ``LOCAL_WORLD_SIZE`` ranks, and ranks on one machine emulate the
    ``prod(dcn_shape)`` slices as contiguous blocks too, so the grid is the
    JAX one either way: the ranks reshaped to ``dcn_shape + ici_shape``,
    then each axis's host factor put outside its in-host factor."""
    world = dist.get_world_size() if world_size is None else int(world_size)
    k = len(axis_names)
    if dcn_shape is None:
        dcn_shape = (1,) * k
    if ici_shape is None:
        ici_shape = (world // int(np.prod(dcn_shape)),) + (1,) * (k - 1)
    if len(dcn_shape) != k or len(ici_shape) != k:
        raise ValueError("dcn_shape/ici_shape must match axis_names length")
    total = int(np.prod(dcn_shape)) * int(np.prod(ici_shape))
    if total != world:
        raise ValueError(f"make_hybrid_layout: prod(dcn)*prod(ici)={total} != {world} ranks")
    grid = np.arange(world).reshape(tuple(dcn_shape) + tuple(ici_shape))
    order = [x for pair in zip(range(k), range(k, 2 * k)) for x in pair]
    shape = tuple(int(d * i) for d, i in zip(dcn_shape, ici_shape))
    return Layout(tuple(axis_names), grid.transpose(order).reshape(shape))


def _as_layout(layout: Union[Layout, Sequence[int]], world: int) -> Layout:
    if isinstance(layout, Layout):
        return layout
    return make_layout((DATA_AXIS, GRAPH_AXIS), tuple(layout), world)


def init_layout(*sizes, axis_names: Sequence[str] = (DATA_AXIS, GRAPH_AXIS),
                layout: Optional[Layout] = None) -> None:
    """Lay the initialized world out as a named grid: ``layout``, or the
    row-major grid of ``sizes`` along ``axis_names`` (``init_layout(D, P)``:
    ``D`` data rows of ``P`` graph columns). Makes every axis's groups (the
    grid's lines along it), in the same order on every rank (every rank
    must call this at once), and registers this rank's own under the axis
    name. An axis that spans the world is the world group."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if layout is None:
        layout = make_layout(axis_names, sizes, world)
    if layout.grid.size != world:
        raise ValueError(f"layout {layout.shape} does not cover the world's {world} ranks")
    for i, axis in enumerate(layout.axis_names):
        lines = np.moveaxis(layout.grid, i, -1).reshape(-1, layout.grid.shape[i])
        if len(lines) == 1:
            register_group(None, axis)
            continue
        for members in lines.tolist():
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


LayoutLike = Union[Layout, Sequence[int], None]


def _register(axis_name: str, layout: LayoutLike) -> None:
    if layout is None:
        register_group(None, axis_name)
    else:
        init_layout(layout=_as_layout(layout, dist.get_world_size()))


def init_graph_group(rank: int, num_parts: int, device: DeviceLike, store_path: str,
                     axis_name: str = GRAPH_AXIS, layout: LayoutLike = None) -> str:
    """Join rank ``rank`` of a world of ``num_parts`` through the
    ``FileStore`` at ``store_path``, register the world as ``axis_name``'s
    group (with ``layout``, a ``Layout`` or ``(D, P)``, the groups of
    ``init_layout`` instead) and return the backend."""
    backend = backend_for(device, num_parts)
    dev = rank_device(device, rank, num_parts)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, num_parts)
    dist.init_process_group(backend, store=store, rank=rank, world_size=num_parts)
    _register(axis_name, layout)
    return backend


def init_from_env(num_parts: int, device: DeviceLike, axis_name: str = GRAPH_AXIS,
                  layout: LayoutLike = None) -> int:
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
    layout: LayoutLike = None,
) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``num_parts`` spawned ranks on ``device``
    (``cuda`` unless named; see ``rank_device``), one group of
    ``axis_name`` or, with ``layout`` (a ``Layout`` or ``(D, P)``), the
    groups of ``init_layout``, and return the
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
                          None if layout is None else _as_layout(layout, num_parts), results))
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

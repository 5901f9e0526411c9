"""The graph process group of edge-partitioned runs (counterpart of
``graphphysics_tpu/parallel/mesh.py``'s ``GRAPH_AXIS``).

The JAX package runs the ``P`` parts of a partitioned graph as ``P``
devices of a ``shard_map`` mesh. The port runs them as ``P``
``torch.distributed`` ranks, one part each; a partitioned graph names its
group in ``Graph.partition_axis`` and the model's exchanges look the group
up here (``graph_group``).

The backend follows from where the ranks sit: one rank per card is NCCL;
ranks that share a card, or run on the CPU, are gloo (NCCL refuses two
ranks on one device). Nothing switches the backend because something
failed.

``launch(fn, num_parts, device)`` starts the ranks as spawned processes,
each joined to the group through a ``FileStore`` in a fresh temporary
directory (no TCP port to race for), runs ``fn(rank, *args)`` in each and
returns their results in rank order; any rank's failure, or the timeout,
stops them all and raises. Under ``torchrun`` (``WORLD_SIZE`` ranks
already started) ``init_from_env`` joins instead.
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
LAUNCH_TIMEOUT_S = 900.0

_GROUPS: Dict[str, Any] = {}


def rank_device(device: DeviceLike, rank: int, num_parts: int) -> torch.device:
    """The device of rank ``rank``: the CPU, card ``rank`` when there is a
    card per rank, else the one card all ranks share."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if torch.cuda.device_count() >= num_parts:
        return torch.device("cuda", rank)
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def backend_for(device: DeviceLike, num_parts: int) -> str:
    """``nccl`` when each rank has a card of its own, ``gloo`` when the
    ranks share a card or run on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= num_parts:
        return "nccl"
    return "gloo"


def register_group(group: Any = None, axis_name: str = GRAPH_AXIS) -> None:
    """Make ``group`` (the default group when None) the process group of
    ``axis_name``."""
    _GROUPS[axis_name] = dist.group.WORLD if group is None else group


def graph_group(axis_name: str = GRAPH_AXIS):
    """The process group of a partitioned graph's ``partition_axis``."""
    group = _GROUPS.get(axis_name)
    if group is None:
        raise RuntimeError(
            f"no process group for partition axis {axis_name!r}: start the ranks with "
            f"parallel.mesh.launch, or join with init_graph_group / init_from_env"
        )
    return group


def graph_rank(axis_name: str = GRAPH_AXIS) -> int:
    return dist.get_rank(graph_group(axis_name))


def graph_size(axis_name: str = GRAPH_AXIS) -> int:
    return dist.get_world_size(graph_group(axis_name))


def group_backend(axis_name: str = GRAPH_AXIS) -> str:
    return str(dist.get_backend(graph_group(axis_name)))


def init_graph_group(rank: int, num_parts: int, device: DeviceLike, store_path: str,
                     axis_name: str = GRAPH_AXIS) -> str:
    """Join rank ``rank`` of ``num_parts`` to the default group through the
    ``FileStore`` at ``store_path``, register it as ``axis_name``'s group
    and return the backend."""
    backend = backend_for(device, num_parts)
    dev = rank_device(device, rank, num_parts)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(store_path, num_parts)
    dist.init_process_group(backend, store=store, rank=rank, world_size=num_parts)
    register_group(None, axis_name)
    return backend


def init_from_env(num_parts: int, device: DeviceLike, axis_name: str = GRAPH_AXIS) -> int:
    """Join a group ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` in the environment); its world size
    must be ``num_parts``. Returns this process's rank."""
    world = int(os.environ["WORLD_SIZE"])
    if world != num_parts:
        raise ValueError(f"WORLD_SIZE {world} != graph_partition {num_parts}")
    rank = int(os.environ["RANK"])
    dev = rank_device(device, rank, num_parts)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(device, num_parts), init_method="env://")
    register_group(None, axis_name)
    return rank


def under_torchrun(num_parts: int) -> bool:
    """True in a process ``torchrun`` started with ``num_parts`` ranks."""
    return os.environ.get("WORLD_SIZE") == str(num_parts) and "RANK" in os.environ


def _rank_main(rank, fn, args, num_parts, device, store_path, axis_name, threads, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_graph_group(rank, num_parts, device, store_path, axis_name)
        try:
            value = fn(rank, *args)
        finally:
            dist.destroy_process_group()
            _GROUPS.pop(axis_name, None)
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
) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``num_parts`` spawned ranks of one graph
    group on ``device`` (``cuda`` unless named; see ``rank_device``) and
    return the results in rank order. ``fn`` and ``args`` must pickle
    (``fn`` a module-level function); ``threads`` sets each rank's
    intra-op threads. Raises with the rank's traceback when one fails, and
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
                          results))
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

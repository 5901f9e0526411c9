"""Multi-process data parallelism (counterpart of
``graphphysics_tpu/parallel/multihost.py``).

The JAX package runs one process per host, each feeding its local devices
its share of the global batch. The port runs one process per device, so a
JAX host's share is one rank's: ``initialize_distributed`` joins the
ranks, ``process_local_indices`` is a rank's interleaved share of a
dataset or of the validation trajectories, and ``MultihostGraphLoader``
gives each rank of the data group its own rows of every global batch,
built by that rank alone. The data group (``parallel.mesh.DATA_AXIS``)
names the ranks unless they are given: in the 2-D layout every rank of one
data row (one graph group) gets the same rows.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch.distributed as dist

from graphphysics_torch.core.device import DeviceLike
from graphphysics_torch.core.graph import Graph
from graphphysics_torch.dataset.loader import GraphLoader, compute_batch_chunks, filler_index


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device: DeviceLike = None) -> None:
    """Join ``num_processes`` processes through ``tcp://coordinator_address``
    (``host:port``; process 0 listens there) as rank ``process_id`` on
    ``device`` (``cuda`` unless named; the backend and card as
    ``parallel.mesh.init_graph_group`` picks them); a no-op for one
    process. The data group is the world then."""
    if num_processes is None or num_processes <= 1:
        return
    import torch

    from graphphysics_torch.parallel.mesh import DATA_AXIS, backend_for, register_group, rank_device

    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed: name the coordinator_address and process_id "
                         "of each of the processes")
    dev = rank_device(device, int(process_id), int(num_processes))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(device, int(num_processes)),
                            init_method=f"tcp://{coordinator_address}", rank=int(process_id),
                            world_size=int(num_processes))
    register_group(None, DATA_AXIS)


def data_ranks(rank: Optional[int] = None, num_ranks: Optional[int] = None) -> Tuple[int, int]:
    """``(rank, num_ranks)`` as given, else this rank's place in the data
    group, else in the world, else ``(0, 1)`` without a process group."""
    if rank is not None and num_ranks is not None:
        return int(rank), int(num_ranks)
    if not dist.is_initialized():
        return 0, 1
    from graphphysics_torch.parallel.mesh import DATA_AXIS, data_rank, data_size

    try:
        return data_rank(DATA_AXIS), data_size(DATA_AXIS)
    except RuntimeError:  # no data group registered: the world
        return dist.get_rank(), dist.get_world_size()


def process_local_indices(total: int, rank: Optional[int] = None,
                          num_ranks: Optional[int] = None) -> np.ndarray:
    """This rank's interleaved share of ``total`` indices,
    ``arange(total)[rank::num_ranks]`` (``data_ranks`` names the rank)."""
    r, n = data_ranks(rank, num_ranks)
    return np.arange(total)[r::n]


def global_batch_from_local(batch: Graph, device: DeviceLike = None) -> Graph:
    """The rank's local stacked batch on its device. In JAX this assembles
    one global array from every host's rows; here each rank is one device
    and the data-parallel step reads only its own rows, so the rows stay as
    they are and only move to the device."""
    return batch.to(device)


class MultihostGraphLoader(GraphLoader):
    """Each rank's ``per_host_batch`` rows of every global batch of
    ``per_host_batch * num_ranks`` graphs, stacked ``[per_host_batch,
    ...]``, built by that rank alone, with JAX's schedule index for index:

    - a dataset without size buckets: each rank takes its interleaved share
      (``process_local_indices``), shuffled with ``SeedSequence([seed,
      epoch])``, and its ``b``-th batch is rows ``[b * B, (b + 1) * B)`` of
      it; ``len`` is ``len(dataset) // num_ranks // per_host_batch``;
    - a size-bucketed one: every rank derives the same bucket-pure global
      chunks (``compute_batch_chunks`` at the global batch size, a bucket
      smaller than one global batch giving its one partial chunk) and takes
      rows ``[rank * B, (rank + 1) * B)`` of each; a short or empty slice is
      filled with fully masked copies of its last graph (of the chunk's
      first where empty), so every rank's batch keeps the chunk's shape.

    ``peek``, ``set_epoch``, ``set_start_batch``, the prefetch thread and
    ``num_workers`` worker processes are ``GraphLoader``'s. ``rank`` and
    ``num_ranks`` default to the data group's (``data_ranks``)."""

    rank_local = True  # batches hold the rank's own rows (Trainer.fit reads this)

    def __init__(self, dataset, per_host_batch: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 0, prefetch: int = 2, rank: Optional[int] = None,
                 num_ranks: Optional[int] = None):
        super().__init__(dataset, batch_size=per_host_batch, shuffle=shuffle, seed=seed,
                         prefetch=prefetch, num_workers=num_workers, collate="stack")
        self.per_host_batch = per_host_batch
        self.rank, self.num_ranks = data_ranks(rank, num_ranks)

    def _order_of(self, rank: int) -> np.ndarray:
        """Rank ``rank``'s share of the items, shuffled per ``(seed,
        epoch)``."""
        idx = process_local_indices(len(self.dataset), rank, self.num_ranks)
        if self.shuffle:
            np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch])).shuffle(idx)
        return idx

    def _order(self) -> np.ndarray:
        return self._order_of(self.rank)

    def global_chunks(self) -> List[np.ndarray]:
        """The bucketed schedule: the global batches' item indices, the
        same on every rank."""
        gb = self.per_host_batch * self.num_ranks

        def chunks_for_count(count, whole_bucket=False):
            n = count // gb
            return 1 if whole_bucket and n == 0 and count > 0 else n

        return compute_batch_chunks(len(self.dataset), gb, seed=self.seed, epoch=self._epoch,
                                    shuffle=self.shuffle, bucket_ids=self._bucket_ids(),
                                    chunks_for_count=chunks_for_count)

    def __len__(self) -> int:
        if self._bucket_ids() is not None:
            return len(self.global_chunks())
        return len(self.dataset) // self.num_ranks // self.per_host_batch

    def _chunks(self) -> List[np.ndarray]:
        """This rank's item indices of each batch; an empty slice of a
        partial chunk is the filler of the chunk's first item
        (``filler_index``), which the collate repeats."""
        b = self.per_host_batch
        if self._bucket_ids() is None:
            idx = self._order()
            return [idx[k * b:(k + 1) * b] for k in range(len(self))]
        out = []
        for chunk in self.global_chunks():
            rows = chunk[self.rank * b:(self.rank + 1) * b]
            out.append(rows if len(rows) else np.array([filler_index(int(chunk[0]))]))
        return out

    def schedule(self) -> List[np.ndarray]:
        """The global batches of the current epoch as every rank can derive
        them: each global batch's item indices, rank by rank (for checking
        that the ranks agree)."""
        if self._bucket_ids() is not None:
            return self.global_chunks()
        b = self.per_host_batch
        orders = [self._order_of(r) for r in range(self.num_ranks)]
        return [np.concatenate([o[k * b:(k + 1) * b] for o in orders]) for k in range(len(self))]

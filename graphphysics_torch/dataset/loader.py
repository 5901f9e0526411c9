"""Batching loader (counterpart of ``graphphysics_tpu/dataset/loader.py``):
items are padded Graphs of one shape, so a batch is their concatenation with
index offsets (``concat_graphs``), one flat graph that the model sees whole,
or, with ``collate="stack"``, their stack along a leading ``[B]`` axis (the
microbatches of a gradient-accumulation step). The order is deterministic
per ``(seed, epoch)``, and with the items' own per-``(seed, epoch, index)``
randomness an epoch's stream can be replayed from any batch
(``set_start_batch``).

A size-bucketed dataset (``num_buckets > 1``) gets bucket-pure batches, so
every batch has one shape, in an order shuffled per epoch
(``compute_batch_chunks``). A partial batch (a bucket smaller than one
batch, always kept, or the last one with ``drop_last=False``) is filled up
to ``batch_size`` with masked copies of its last graph
(``core.graph.masked_filler``), which add nothing to the loss, the
gradients or the normalizers.

Batches are built on the host while the card trains: by a background thread
(``prefetch`` batches ahead) or, with ``num_workers > 0``, by worker
processes of a ``torch.utils.data.DataLoader`` (spawned, persistent across
epochs), which give the same batches bit for bit."""

from __future__ import annotations

import functools
import os
import pickle
import queue
import tempfile
import threading
import weakref
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from graphphysics_torch.core.graph import Graph, concat_graphs, masked_filler, stack_graphs

# seconds the parent waits for one batch from the workers before it raises
# (the first batch includes the workers' start: a fresh interpreter each)
WORKER_TIMEOUT_S = 300.0
# seconds a consumer that abandons an epoch waits for the prefetch thread
PREFETCH_JOIN_S = 60.0


def filler_index(index: int) -> int:
    """The task of a fully masked copy of item ``index``
    (``core.graph.masked_filler``): ``-1 - index``. A rank's empty slice of a
    partial global batch (``parallel.multihost.MultihostGraphLoader``) asks
    for one, which the collate repeats."""
    return -1 - index


def build_item(dataset, task: int) -> Graph:
    """Item ``task`` of ``dataset``, or the masked copy a negative task
    (``filler_index``) names."""
    task = int(task)
    return dataset[task] if task >= 0 else masked_filler(dataset[-1 - task])


class EpochItems(torch.utils.data.Dataset):
    """The dataset as the loader's workers see it. It travels as the path
    of a file that holds the pickled dataset, which each worker reads at its
    first item: a spawned worker's start writes its arguments through a pipe
    that blocks the parent until the child has read them, so a dataset of
    megabytes in the arguments would start the workers one after another.
    An item is asked for as ``(index, epoch)``, because a persistent
    worker's copy of the dataset never sees the parent's ``set_epoch``; the
    copy follows the epoch of each task."""

    def __init__(self, path: str, length: int):
        self.path, self.length = path, length
        self.dataset = None
        self._epoch: Optional[int] = None

    def __len__(self) -> int:
        return self.length

    def __getstate__(self):
        return {**self.__dict__, "dataset": None, "_epoch": None}

    def __getitem__(self, task: Tuple[int, int]) -> Graph:
        if self.dataset is None:
            with open(self.path, "rb") as fp:
                self.dataset = pickle.load(fp)  # written by this loader's parent
        index, epoch = task
        if epoch != self._epoch and hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        self._epoch = epoch
        return build_item(self.dataset, index)


class EpochBatches(torch.utils.data.Sampler):
    """The batch sampler of the workers' ``DataLoader``: the tasks of the
    batches the parent assigned for the next iteration."""

    def __init__(self):
        self.batches: List[List[Tuple[int, int]]] = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


def init_worker(worker_id: int, build_dir: Optional[str] = None) -> None:
    """A loader worker builds items on the host only: one torch thread, and
    no card visible to it. It looks for the host C++ graph builders'
    library (``graphphysics_torch.native``) in ``build_dir``, the parent's
    build directory."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    if build_dir is not None:
        from graphphysics_torch.ops import _native

        _native.set_build_dir(build_dir)


def materialize_static_shapes(dataset, first_index: int) -> None:
    """Build one item where a padding budget is still unset (the node and
    edge budgets, the ELL degree, or with buckets the bucket budgets), so
    the workers inherit the parent's budgets through the pickle instead of
    each deriving its own."""
    done = getattr(dataset, "_budgets_done", None)
    if done is not None and not done():
        dataset[int(first_index)]


class Collate:
    """A batch from its items: up to ``batch_size`` graphs, filled with
    masked copies of the last (``masked_filler``) where fewer, then
    concatenated (``"concat"``) or stacked (``"stack"``). Picklable, so the
    loader's worker processes collate as the parent does."""

    def __init__(self, batch_size: int, mode: str = "concat"):
        if mode not in ("concat", "stack"):
            raise ValueError(f"unknown collate {mode!r}")
        self.batch_size, self.mode = batch_size, mode

    def __call__(self, graphs: Sequence[Graph]) -> Graph:
        graphs = list(graphs)
        if len(graphs) < self.batch_size:
            graphs += [masked_filler(graphs[-1])] * (self.batch_size - len(graphs))
        return stack_graphs(graphs) if self.mode == "stack" else concat_graphs(graphs)


def compute_batch_chunks(
    total: int,
    batch_size: int,
    *,
    seed: int,
    epoch: int,
    shuffle: bool,
    bucket_ids: Optional[np.ndarray],
    chunks_for_count,
) -> List[np.ndarray]:
    """The item indices of each batch of an epoch, as the JAX package's
    ``compute_batch_chunks``: the items shuffled with
    ``SeedSequence([seed, epoch])``; with ``bucket_ids`` grouped bucket by
    bucket (every chunk one shape) and the chunks' order shuffled with
    ``SeedSequence([seed, epoch, 1])``. ``chunks_for_count(count,
    whole_bucket=False)`` is the number of batches of ``count`` items."""
    order = np.arange(total)
    if shuffle:
        np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(order)
    bs = batch_size
    if bucket_ids is None:
        return [order[b * bs : (b + 1) * bs] for b in range(chunks_for_count(total))]
    oid = bucket_ids[order]
    chunks = []
    for b in np.unique(oid):
        sel = order[oid == b]
        chunks += [sel[j * bs : (j + 1) * bs]
                   for j in range(chunks_for_count(len(sel), whole_bucket=True))]
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch, 1]))
        chunks = [chunks[int(p)] for p in rng.permutation(len(chunks))]
    return chunks


def dataset_bucket_ids(dataset) -> Optional[np.ndarray]:
    """The bucket of every item of a size-bucketed dataset, or None when it
    has no buckets (or they collapsed to one)."""
    if getattr(dataset, "num_buckets", 1) <= 1:
        return None
    if len(dataset):
        dataset.bucket_of_index(0)  # materializes the buckets (they may collapse)
    if dataset.num_buckets <= 1:
        return None
    return np.repeat(dataset._traj_bucket, dataset.frames_per_trajectory)[: len(dataset)]


class GraphLoader:
    """Batches of ``batch_size`` dataset items, concatenated (``collate``
    "concat") or stacked ("stack"). ``shuffle`` permutes the items with
    ``SeedSequence([seed, epoch])``. With ``drop_last`` (the default) a
    last partial batch is dropped, else filled with masked copies, so every
    batch keeps one shape; a size bucket smaller than one batch is never
    dropped.

    ``num_workers == 0``: with ``prefetch > 0`` a background thread builds
    up to ``prefetch`` batches ahead of the consumer (stopped and joined when
    the consumer abandons the epoch), with ``prefetch == 0`` the consumer's
    thread builds each batch when it asks for it. ``num_workers > 0``: that
    many spawned worker processes build and concatenate the batches, each
    keeping up to ``prefetch`` (at least 1) ahead; they persist across
    epochs until ``close``. A worker's exception reaches the caller, and
    waiting more than ``timeout`` seconds for a batch raises. The dataset
    must pickle (``H5Dataset`` drops its file handle)."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        num_workers: int = 0,
        timeout: float = WORKER_TIMEOUT_S,
        drop_last: bool = True,
        collate: str = "concat",
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if prefetch < 0 or num_workers < 0:
            raise ValueError(f"prefetch and num_workers must be >= 0, got {prefetch}, {num_workers}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.timeout = timeout
        self.drop_last = drop_last
        self._collate = Collate(batch_size, collate)
        self._bucket_ids_cache: Optional[np.ndarray] = None
        self._epoch = 0
        self._start_batch = 0
        self._workers: Optional[torch.utils.data.DataLoader] = None
        self._tasks = EpochBatches()
        self._dataset_file = None  # removes the workers' copy of the dataset

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the next iteration (order and item randomness)."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def set_start_batch(self, batch: int) -> None:
        """Skip the first ``batch`` batches of the next iteration only."""
        self._start_batch = int(batch)

    def _bucket_ids(self) -> Optional[np.ndarray]:
        """Each item's bucket for a size-bucketed dataset, else None;
        computed once (the assignment does not change)."""
        if self._bucket_ids_cache is None:
            self._bucket_ids_cache = dataset_bucket_ids(self.dataset)
        return self._bucket_ids_cache

    def _num_chunks(self, count: int, whole_bucket: bool = False) -> int:
        """Batches of ``count`` items. ``whole_bucket``: a bucket smaller
        than one batch still gives its partial batch, since dropping it
        would leave a mesh size out of every epoch."""
        if self.drop_last:
            n = count // self.batch_size
            return 1 if whole_bucket and n == 0 and count > 0 else n
        return (count + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        ids = self._bucket_ids()
        if ids is None:
            return self._num_chunks(len(self.dataset))
        return sum(self._num_chunks(int((ids == b).sum()), whole_bucket=True) for b in np.unique(ids))

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch]))
            rng.shuffle(idx)
        return idx

    def _chunks(self) -> List[np.ndarray]:
        return compute_batch_chunks(
            len(self.dataset), self.batch_size, seed=self.seed, epoch=self._epoch,
            shuffle=self.shuffle, bucket_ids=self._bucket_ids(), chunks_for_count=self._num_chunks,
        )

    def peek(self) -> Graph:
        """The first batch of the current epoch, built now (for shapes and
        initialization), without advancing anything."""
        chunks = self._chunks()
        idx = chunks[0] if chunks else self._order()[: self.batch_size]
        return self._collate([build_item(self.dataset, i) for i in idx])

    def __iter__(self) -> Iterator[Graph]:
        chunks = self._chunks()
        start, self._start_batch = self._start_batch, 0  # one-shot
        chunks = chunks[start:]
        if self.num_workers > 0:
            return self._from_workers(chunks)
        if self.prefetch > 0:
            return self._prefetched(chunks)
        return self._in_process(chunks)

    def _in_process(self, chunks: Sequence[np.ndarray]) -> Iterator[Graph]:
        for idx in chunks:
            yield self._collate([build_item(self.dataset, i) for i in idx])

    def _prefetched(self, chunks: Sequence[np.ndarray]) -> Iterator[Graph]:
        """``_in_process`` on a background thread, up to ``prefetch``
        batches ahead; its exception is raised here, in order."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self._in_process(chunks):
                    if not put(batch):
                        return
                put(done)
            except BaseException as err:  # relayed to the consumer, which raises it
                put(err)

        thread = threading.Thread(target=produce, name="GraphLoader-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=PREFETCH_JOIN_S)

    def _from_workers(self, chunks: Sequence[np.ndarray]) -> Iterator[Graph]:
        if self._workers is None:
            from graphphysics_torch.ops import _native

            first = int(chunks[0][0]) if chunks else 0
            materialize_static_shapes(self.dataset, first if first >= 0 else -1 - first)
            fd, path = tempfile.mkstemp(prefix="graphloader-", suffix=".pkl")
            self._dataset_file = weakref.finalize(self, os.remove, path)
            with os.fdopen(fd, "wb") as fp:
                pickle.dump(self.dataset, fp, protocol=pickle.HIGHEST_PROTOCOL)
            self._workers = torch.utils.data.DataLoader(
                EpochItems(path, len(self.dataset)),
                batch_sampler=self._tasks,
                num_workers=self.num_workers,
                collate_fn=self._collate,
                persistent_workers=True,
                multiprocessing_context="spawn",
                prefetch_factor=max(self.prefetch, 1),
                timeout=self.timeout,
                worker_init_fn=functools.partial(init_worker, build_dir=str(_native.BUILD_DIR)),
            )
        # the tasks are read when the iterator starts (below), before the
        # next epoch can assign its own
        self._tasks.batches = [[(int(i), self._epoch) for i in idx] for idx in chunks]
        return iter(self._workers)

    def close(self) -> None:
        """Stop the worker processes and remove their copy of the dataset
        (idempotent); the next iteration with workers starts new ones."""
        workers, self._workers = self._workers, None
        it = getattr(workers, "_iterator", None)
        if it is not None:
            it._shutdown_workers()
        if self._dataset_file is not None:
            self._dataset_file()
            self._dataset_file = None

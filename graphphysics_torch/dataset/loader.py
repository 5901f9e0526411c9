"""Batching loader (counterpart of ``graphphysics_tpu/dataset/loader.py``),
single process: items are padded Graphs of one shape, so a batch is their
concatenation with index offsets (``concat_graphs``), one flat graph that
the model sees whole. The order is deterministic per ``(seed, epoch)``, and
with the items' own per-``(seed, epoch, index)`` randomness an epoch's
stream can be replayed from any batch (``set_start_batch``). Worker
processes and size buckets come with later slices."""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from graphphysics_torch.core.graph import Graph, concat_graphs


class GraphLoader:
    """Batches of ``batch_size`` dataset items, concatenated. ``shuffle``
    permutes the items with ``SeedSequence([seed, epoch])``. A last partial
    batch is dropped, so every batch keeps one shape."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._start_batch = 0

    def set_epoch(self, epoch: int) -> None:
        """The epoch of the next iteration (order and item randomness)."""
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def set_start_batch(self, batch: int) -> None:
        """Skip the first ``batch`` batches of the next iteration only."""
        self._start_batch = int(batch)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch]))
            rng.shuffle(idx)
        return idx

    def _chunks(self) -> List[np.ndarray]:
        order = self._order()
        bs = self.batch_size
        return [order[b * bs : (b + 1) * bs] for b in range(len(self))]

    def peek(self) -> Graph:
        """The first batch of the current epoch, built now (for shapes and
        initialization), without advancing anything."""
        chunks = self._chunks()
        idx = chunks[0] if chunks else self._order()[: self.batch_size]
        return concat_graphs([self.dataset[int(i)] for i in idx])

    def __iter__(self) -> Iterator[Graph]:
        chunks = self._chunks()
        start, self._start_batch = self._start_batch, 0  # one-shot
        for b in range(start, len(chunks)):
            yield concat_graphs([self.dataset[int(i)] for i in chunks[b]])

"""The worker-process cases of ``test_torch_port_loader_workers.py``, each run
in a subprocess of its own with a timeout, so a hung worker cannot hold the
test run:

    python -m tests._torch_port_loader_cases CASE H5_PATH META_PATH

A case raises on failure and prints ``ok`` on success. The module imports
the port only (no JAX): spawned loader workers import it to unpickle the
datasets defined here. Every loader uses 2 workers and a finite timeout."""

import os
import sys
import time

import numpy as np
import torch

from graphphysics_torch.dataset import GraphLoader, H5Dataset, build_preprocessing

WORKERS = 2
TIMEOUT_S = 60.0  # the DataLoader's wait for one batch
FIELDS = ("x", "y", "pos", "senders", "receivers", "edge_attr", "node_mask", "edge_mask",
          "exclude_mask", "row_bounds", "sender_bounds")
NOISE = {"noise_index_start": [0], "noise_index_end": [2], "noise_scale": 0.1, "node_type_index": 2}

torch.set_num_threads(1)


def dataset(h5_path, meta_path, **options):
    """A noisy cylinder dataset with random edges and node masking: every
    epoch draws anew."""
    options = {"masking_ratio": 0.3, "new_edges_ratio": 0.1, "edge_headroom": 1.5, **options}
    return H5Dataset(h5_path, meta_path, preprocessing=build_preprocessing(noise_parameters=NOISE),
                     node_type_index=2, **options)


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0, (len(got), len(want))
    for b, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS:
            a, c = getattr(g, f), getattr(w, f)
            assert (a is None) == (c is None), (b, f)
            if a is not None:
                assert a.dtype == c.dtype and np.array_equal(a, c), (b, f)


def pids(loader):
    return sorted(w.pid for w in loader._workers._iterator._workers)


class BoomDataset:
    """Items of three zeros; item 1 raises."""

    def __len__(self):
        return 4

    def __getitem__(self, index):
        if index == 1:
            raise ValueError(f"boom at {index}")
        return np.zeros(3)


class SlowDataset(BoomDataset):
    """Item 1 takes far longer than the loader's timeout."""

    def __getitem__(self, index):
        if index == 1:
            time.sleep(120)
        return np.zeros(3)


def case_match(h5_path, meta_path):
    """Two epochs and a resumed one: the workers' batches equal the
    in-process loader's bit for bit, from workers that persist."""
    ref = GraphLoader(dataset(h5_path, meta_path), batch_size=2, shuffle=True, seed=3, prefetch=0)
    ds = dataset(h5_path, meta_path)
    loader = GraphLoader(ds, batch_size=2, shuffle=True, seed=3, prefetch=1, num_workers=WORKERS,
                         timeout=TIMEOUT_S)
    assert ds.node_budget is None  # the loader sets the budgets before the workers start
    try:
        first = None
        for epoch in (0, 1):
            ref.set_epoch(epoch)
            loader.set_epoch(epoch)
            assert_batches_equal(list(loader), list(ref))
            first = first or pids(loader)
            assert pids(loader) == first  # the same processes every epoch
            assert ds.node_budget is not None
        for epoch, start in ((1, 2), (0, 1)):
            ref.set_epoch(epoch)
            loader.set_epoch(epoch)
            want = list(ref)[start:]
            loader.set_start_batch(start)
            assert_batches_equal(list(loader), want)
        assert_batches_equal(list(loader), list(ref))  # the start is one-shot
        assert ref.peek().x.shape == loader.peek().x.shape
        copy = loader._workers.dataset.path  # the workers' copy of the dataset
        assert os.path.exists(copy)
    finally:
        loader.close()
    assert loader._workers is None and not os.path.exists(copy)
    for pid in first:
        for _ in range(100):
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"worker {pid} still alive after close")


def case_abandoned(h5_path, meta_path):
    """An epoch abandoned after one batch leaves the workers serving the
    next epoch, whole and equal to the in-process one."""
    ds = dataset(h5_path, meta_path)
    loader = GraphLoader(ds, batch_size=2, shuffle=True, seed=1, prefetch=2, num_workers=WORKERS,
                         timeout=TIMEOUT_S)
    ref = GraphLoader(dataset(h5_path, meta_path), batch_size=2, shuffle=True, seed=1, prefetch=0)
    try:
        it = iter(loader)
        next(it)
        del it
        before = pids(loader)
        loader.set_epoch(1)
        ref.set_epoch(1)
        assert_batches_equal(list(loader), list(ref))
        assert pids(loader) == before
    finally:
        loader.close()


def case_exception(h5_path, meta_path):
    """A worker's exception reaches the caller with its message."""
    loader = GraphLoader(BoomDataset(), batch_size=1, num_workers=WORKERS, timeout=TIMEOUT_S)
    try:
        it = iter(loader)
        try:
            for _ in it:
                pass
        except ValueError as err:
            assert "boom at 1" in str(err), err
        else:
            raise AssertionError("the worker's exception did not reach the caller")
    finally:
        loader.close()


def case_timeout(h5_path, meta_path):
    """A batch that takes longer than ``timeout`` raises, without waiting
    for the worker."""
    loader = GraphLoader(SlowDataset(), batch_size=1, num_workers=WORKERS, timeout=3.0)
    t0 = time.time()
    try:
        for _ in loader:
            pass
    except RuntimeError as err:
        assert "timed out" in str(err), err
    else:
        raise AssertionError("no timeout")
    finally:
        loader.close()
    assert time.time() - t0 < 60


def case_buckets(h5_path, meta_path):
    """A size-bucketed dataset of mixed mesh sizes (``test_torch_port_buckets``
    writes it) through the workers, stacked, with partial buckets filled by
    masked copies (``drop_last=False``): the workers' batches equal the
    in-process ones over two epochs, every batch bucket-pure."""
    def loader(workers):
        ds = dataset(h5_path, meta_path, num_buckets=2, bucket_multiple=64, masking_ratio=None,
                     new_edges_ratio=0.0)
        return GraphLoader(ds, batch_size=4, shuffle=True, seed=5, prefetch=1,
                           num_workers=workers, timeout=TIMEOUT_S, collate="stack",
                           drop_last=False)

    ref, par = loader(0), loader(WORKERS)
    try:
        for epoch in range(2):
            ref.set_epoch(epoch)
            par.set_epoch(epoch)
            want, got = list(ref), list(par)
            assert_batches_equal(got, want)
            assert {b.x.shape[1] for b in got} == {64, 192}
            # 10 items a bucket in batches of 4: each bucket's last batch
            # holds 2 real graphs and 2 masked copies
            filled = [b for b in got if not b.node_mask[-1].any()]
            assert len(got) == 6 and len(filled) == 2
            assert all(b.node_mask[1].any() and not b.edge_mask[2:].any() for b in filled)
    finally:
        par.close()


CASES = {"match": case_match, "abandoned": case_abandoned, "exception": case_exception,
         "timeout": case_timeout}
# cases run by other test files, on their own data
OTHER_CASES = {"buckets": case_buckets}


if __name__ == "__main__":
    {**CASES, **OTHER_CASES}[sys.argv[1]](*sys.argv[2:4])
    print("ok", flush=True)

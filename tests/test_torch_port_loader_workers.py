"""The port's ``GraphLoader`` builds batches ahead of the consumer: on a
background thread (``prefetch``) or in spawned worker processes
(``num_workers``, a ``torch.utils.data.DataLoader``). Both give the in-process
batches bit for bit, for every epoch and after ``set_start_batch``; a
worker's exception and a batch that takes longer than the timeout reach the
caller; an abandoned epoch stops the thread and keeps the workers; ``close``
stops them. Datasets cross into the workers by pickling: ``H5Dataset``
drops its file handle and trajectory cache. Twins of ``test_dataset.py``'s
``test_loader_multiprocess_workers``, ``test_worker_pickle_drops_h5_handle``,
``test_multiworker_pool_persists_and_tracks_epochs``,
``test_multiworker_abandoned_epoch_keeps_pool_alive`` and
``test_spawn_pool_propagates_worker_exception`` (a DataLoader serves one
iterator at a time, so the interleaved-iterators case has no twin).

The worker cases (``tests/_torch_port_loader_cases.py``) run in a subprocess
each, under ``SUBPROCESS_TIMEOUT_S``, with 2 workers, a DataLoader timeout and
tiny data."""

import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from graphphysics_tpu.utils.synthetic import write_aneurysm_xdmf, write_cylinder_h5
from graphphysics_torch.dataset import GraphLoader, H5Dataset, XDMFDataset, build_preprocessing
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)
from tests._torch_port_loader_cases import CASES, assert_batches_equal, dataset

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    d = tmp_path_factory.mktemp("cyl_workers")
    return write_cylinder_h5(str(d), num_traj=2, steps=5, nx=8, ny=6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_worker_loader(cylinder, case):
    out = subprocess.run(
        [sys.executable, "-m", "tests._torch_port_loader_cases", case, *cylinder],
        cwd=ROOT, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-4000:]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "GraphLoader-prefetch"]


@pytest.mark.parametrize("prefetch", [1, 3])
def test_prefetch_thread_matches_in_process(cylinder, prefetch):
    ref = GraphLoader(dataset(*cylinder), batch_size=2, shuffle=True, seed=4, prefetch=0)
    loader = GraphLoader(dataset(*cylinder), batch_size=2, shuffle=True, seed=4, prefetch=prefetch)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        loader.set_epoch(epoch)
        assert_batches_equal(list(loader), list(ref))
    loader.set_start_batch(1)
    assert_batches_equal(list(loader), list(ref)[1:])
    assert not _prefetch_threads()


def test_abandoned_prefetch_epoch_joins_its_thread(cylinder):
    loader = GraphLoader(dataset(*cylinder), batch_size=1, shuffle=True, prefetch=2)
    it = iter(loader)
    next(it)
    assert len(_prefetch_threads()) == 1
    it.close()
    assert not _prefetch_threads()
    assert len(list(loader)) == len(loader)


class _FailingItems:
    """Items of a one-node graph; item 2 raises."""

    def __len__(self):
        return 3

    def __getitem__(self, index):
        from graphphysics_torch.core.graph import Graph

        if index == 2:
            raise KeyError("no item 2")
        z = np.zeros((1, 1), np.float32)
        return Graph(x=z, pos=z, senders=np.zeros(1, np.int32), receivers=np.zeros(1, np.int32),
                     edge_attr=None, node_mask=np.ones(1, bool), edge_mask=np.ones(1, bool), y=None)


def test_prefetch_thread_relays_its_exception():
    got = []
    with pytest.raises(KeyError, match="no item 2"):
        for batch in GraphLoader(_FailingItems(), batch_size=1, prefetch=2):
            got.append(batch)
    assert len(got) == 2
    t0 = time.time()
    while _prefetch_threads() and time.time() - t0 < 10:
        time.sleep(0.05)
    assert not _prefetch_threads()


def test_loader_options_are_checked(cylinder):
    with pytest.raises(ValueError, match=">= 0"):
        GraphLoader(dataset(*cylinder), num_workers=-1)
    with pytest.raises(ValueError, match=">= 1"):
        GraphLoader(dataset(*cylinder), batch_size=0)


def test_worker_pickle_drops_h5_handle(cylinder):
    """A worker's copy of an ``H5Dataset`` holds no handle and no cached
    trajectory; it opens the file itself and gives the same items."""
    ds = H5Dataset(*cylinder, preprocessing=build_preprocessing(), node_type_index=2)
    ref = ds[0]
    assert ds._file is not None and len(ds._traj_cache) == 1
    copy = pickle.loads(pickle.dumps(ds))
    assert copy._file is None and len(copy._traj_cache) == 0
    assert ds._file is not None  # the parent keeps its own
    np.testing.assert_array_equal(copy[0].x, ref.x)
    ds.close()
    copy.close()


def test_xdmf_dataset_pickles(tmp_path):
    """An ``XDMFDataset`` keeps no open file (each read opens and closes
    one): its copy gives the same items."""
    folder, meta = write_aneurysm_xdmf(str(tmp_path / "train"), num_traj=2, steps=4, n=3)
    ds = XDMFDataset(folder, meta, node_type_index=3)
    ref = ds[1]
    copy = pickle.loads(pickle.dumps(ds))
    np.testing.assert_array_equal(copy[1].x, ref.x)
    np.testing.assert_array_equal(copy[1].senders, ref.senders)

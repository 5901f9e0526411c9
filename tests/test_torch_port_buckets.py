"""Port parity, size buckets and the loader's partial batches: bucket ids
and budgets against the JAX dataset's, the loader's batch chunks against
the JAX ``compute_batch_chunks``, bucket-pure batches, the small bucket
kept and filled with masked copies (``masked_filler``), which add nothing
to the loss, the gradients or the normalizers, ``drop_last=False``, the
XDMF metadata-only scan feeding the buckets, the worker loader, and a
bucketed ``fit`` with validation (twins of ``tests/test_buckets.py``).
Everything runs on the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphphysics_tpu.dataset import loader as jax_loader
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.utils.synthetic import write_aneurysm_xdmf, write_cylinder_h5
from graphphysics_torch.core.graph import concat_graphs, masked_filler
from graphphysics_torch.dataset import GraphLoader
from graphphysics_torch.dataset.loader import compute_batch_chunks, dataset_bucket_ids
from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

ROOT = Path(__file__).resolve().parents[1]
SUBPROCESS_TIMEOUT_S = 240
# two mesh sizes: 6 x 5 = 30 and 14 x 10 = 140 nodes
GRIDS = [(6, 5), (6, 5), (14, 10), (14, 10)]
# a batch with filler against its real graphs alone: the same sums with
# zero terms added, so equal up to the order of f32 sums
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-7


def _param(h5_path, meta_path, kind="epd", **dataset):
    model = {"type": "epd", "message_passing_num": 1, "hidden_size": 8, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3}
    if kind == "transformer":
        model = {**model, "type": "transformer", "edge_input_size": 0, "num_heads": 2}
    return {
        "dataset": {"extension": "h5", "h5_path": h5_path, "meta_path": meta_path, "khop": 1,
                    "num_buckets": 2, **dataset},
        "model": model,
        "index": {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
                  "output_index_end": 2, "node_type_index": 2},
        "transformations": {
            "preprocessing": {"noise": 0.02, "noise_index_start": [0], "noise_index_end": [2],
                              "masking": 0},
            "world_pos_parameters": {"use": False},
        },
    }


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    d = tmp_path_factory.mktemp("buckets")
    return write_cylinder_h5(str(d), steps=6, grids=GRIDS)


def _datasets(mixed, kind="epd", **dataset):
    param = _param(*mixed, kind, **dataset)
    edges = kind == "epd"
    ours = get_dataset(param, get_preprocessing(param, use_edge_feature=edges), use_edge_feature=edges)
    theirs = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges),
                                use_edge_feature=edges)
    return ours, theirs


def test_bucket_assignment_and_budgets_match_jax(mixed):
    ds, jds = _datasets(mixed, bucket_multiple=64)
    big_index = ds.trajectory_indices(2)[0]
    small, big = ds[0], ds[big_index]
    jsmall, jbig = jds[0], jds[big_index]
    assert small.x.shape[0] == jsmall.x.shape[0] == 64
    assert big.x.shape[0] == jbig.x.shape[0] == 192
    assert small.senders.shape == jsmall.senders.shape and big.senders.shape == jbig.senders.shape
    assert ds.num_buckets == jds.num_buckets == 2
    assert ds._bucket_node_budgets == jds._bucket_node_budgets
    assert ds._bucket_edge_budgets == jds._bucket_edge_budgets
    assert [ds.bucket_of_index(i) for i in range(len(ds))] == [
        jds.bucket_of_index(i) for i in range(len(jds))]
    np.testing.assert_array_equal(dataset_bucket_ids(ds), jax_loader.dataset_bucket_ids(jds))
    # the real rows intact under the smaller budget; the receiver-sorted layout
    assert int(small.node_mask.sum()) == 30 and int(big.node_mask.sum()) == 140
    assert small.row_bounds is not None and small.row_bounds.shape == (2, 64)


def test_bucket_reduction_collapse_and_the_csr_layout(mixed, tmp_path):
    ds, _ = _datasets(mixed, num_buckets=1)
    assert ds[0].x.shape == ds[ds.trajectory_indices(2)[0]].x.shape
    uniform = write_cylinder_h5(str(tmp_path), num_traj=2, steps=4, nx=6, ny=5)
    param = _param(*uniform, num_buckets=4)
    ds = get_dataset(param, get_preprocessing(param))
    _ = ds[0]
    assert ds.num_buckets == 1 and ds.node_budget is not None and dataset_bucket_ids(ds) is None
    # CSR buckets: whole node blocks of the JAX kernel, the model's layout
    ds, jds = _datasets(mixed, "transformer", bucket_multiple=64)
    g = ds[0]
    assert ds._bucket_node_budgets == [128, 256] and g.sender_bounds is not None
    assert [ds.bucket_of_index(i) for i in range(len(ds))] == [
        jds.bucket_of_index(i) for i in range(len(jds))]
    with pytest.raises(ValueError, match="sorted or csr"):
        get_dataset(_param(*mixed, edge_layout="ell"), get_preprocessing(_param(*mixed)))
    with pytest.raises(ValueError, match="num_buckets must be >= 1"):
        get_dataset(_param(*mixed, num_buckets=0), get_preprocessing(_param(*mixed)))


@pytest.mark.parametrize("batch_size,drop_last", [(2, True), (3, True), (3, False), (16, True)])
def test_loader_chunks_are_jax_compute_batch_chunks(mixed, batch_size, drop_last):
    ds, jds = _datasets(mixed, bucket_multiple=64)
    loader = GraphLoader(ds, batch_size=batch_size, shuffle=True, seed=3, prefetch=0,
                         drop_last=drop_last)
    jloader = jax_loader.GraphLoader(jds, batch_size=batch_size, shuffle=True, seed=3, prefetch=0,
                                     drop_last=drop_last)
    assert len(loader) == len(jloader)
    for epoch in range(3):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        got, want = loader._chunks(), jloader._batch_chunks()
        assert [c.tolist() for c in got] == [c.tolist() for c in want]
        # the shared function as well, with and without buckets
        for ids in (None, dataset_bucket_ids(ds)):
            args = dict(seed=7, epoch=epoch, shuffle=True, bucket_ids=ids,
                        chunks_for_count=loader._num_chunks)
            assert [c.tolist() for c in compute_batch_chunks(len(ds), batch_size, **args)] == [
                c.tolist() for c in jax_loader.compute_batch_chunks(len(ds), batch_size, **args)]


def test_loader_groups_batches_by_bucket(mixed):
    ds, _ = _datasets(mixed, bucket_multiple=64)
    loader = GraphLoader(ds, batch_size=2, shuffle=True, seed=3, prefetch=0)
    assert len(loader) == 10  # 4 trajectories x 5 frames, 10 a bucket
    seen = {64: 0, 192: 0}
    for epoch in range(2):
        loader.set_epoch(epoch)
        for batch in loader:
            seen[batch.x.shape[0] // 2] += 1
    assert seen == {64: 10, 192: 10}


def test_small_bucket_kept_and_filled_with_masked_copies(mixed):
    ds, _ = _datasets(mixed, bucket_multiple=64)
    for collate in ("concat", "stack"):
        loader = GraphLoader(ds, batch_size=16, shuffle=False, prefetch=0, collate=collate)
        batches = list(loader)
        assert len(loader) == len(batches) == 2  # one partial batch a bucket
        for b in batches:
            valid = b.node_mask.reshape(16, -1).sum(axis=1)
            assert all(valid[:10] > 0) and all(valid[10:] == 0)
            assert b.edge_mask.reshape(16, -1)[10:].sum() == 0
            if collate == "stack":
                assert b.x.shape[0] == 16
    # a bucket with a full batch still drops its tail
    assert len(GraphLoader(ds, batch_size=8, shuffle=False, prefetch=0)) == 2
    # drop_last=False fills the last batch of an unbucketed dataset
    flat, _ = _datasets(mixed, num_buckets=1)
    loader = GraphLoader(flat, batch_size=3, prefetch=0, drop_last=False)
    last = list(loader)[-1]
    assert len(loader) == 7 and last.node_mask.reshape(3, -1).sum(axis=1)[2] == 0


def test_peek_falls_back_when_no_full_batch(mixed):
    ds, _ = _datasets(mixed, num_buckets=1)
    loader = GraphLoader(ds, batch_size=1000, shuffle=False, prefetch=0)
    assert len(loader) == 0 and loader.peek().x.shape[0] > 0


def test_budgets_canonical_across_first_touched_index(mixed):
    ds_a, _ = _datasets(mixed, bucket_multiple=64)
    ds_b, _ = _datasets(mixed, bucket_multiple=64)
    big = ds_b.trajectory_indices(2)[0]
    ds_a[0]
    ds_b[big]
    ds_a[big]
    ds_b[0]
    assert ds_a._bucket_node_budgets == ds_b._bucket_node_budgets
    assert ds_a._bucket_edge_budgets == ds_b._bucket_edge_budgets
    for i in (0, big):
        assert ds_a[i].senders.shape == ds_b[i].senders.shape


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_filler_adds_nothing(mixed, kind):
    """A batch of 3 real graphs and 1 filler against the 3 alone: the same
    loss, gradients and normalizer statistics."""
    ds, _ = _datasets(mixed, kind, bucket_multiple=64)
    real = [ds[i] for i in range(3)]
    param = _param(*mixed, kind)
    results = []
    for graphs in (real, real + [masked_filler(real[-1])]):
        trainer = Trainer(param, learning_rate=1e-3, warmup=0, device="cpu")
        trainer.init_state(1)
        batch = concat_graphs(graphs).to("cpu")
        out, target, _ = trainer.sim(batch, is_training=True)
        loss = trainer.loss(target, out, batch)
        loss.backward()
        stats = {k: v.clone() for k, v in trainer.sim.state_dict().items() if "normalizer" in k}
        results.append((loss.item(), {n: p.grad for n, p in trainer.sim.named_parameters()}, stats))
    (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) = results
    np.testing.assert_allclose(loss_b, loss_a, rtol=LOSS_RTOL)
    for name, g in grads_a.items():
        torch.testing.assert_close(grads_b[name], g, rtol=GRAD_RTOL, atol=GRAD_ATOL, msg=name)
    for key, v in stats_a.items():
        torch.testing.assert_close(stats_b[key], v, rtol=1e-6, atol=1e-6, msg=key)
        if key.endswith(("_acc_count", "_num_accumulations")):
            assert torch.equal(stats_b[key], v), key


def test_xdmf_bucket_assignment(tmp_path):
    """XDMF datasets scan each file's node count from its metadata for the
    bucket tables, as the JAX package's."""
    folder, meta_path = write_aneurysm_xdmf(str(tmp_path), steps=4, sizes=[3, 5])
    param = {
        "dataset": {"extension": "xdmf", "xdmf_folder": folder, "meta_path": meta_path, "khop": 1,
                    "num_buckets": 2, "bucket_multiple": 32, "edge_headroom": 1.6},
        "model": {"type": "epd"},
        "index": {"feature_index_start": 0, "feature_index_end": 3, "output_index_start": 0,
                  "output_index_end": 3, "node_type_index": 3},
        "transformations": {"preprocessing": {"noise": 0.0, "noise_index_start": [0],
                                              "noise_index_end": [3], "masking": 0},
                            "world_pos_parameters": {"use": False}},
    }
    ds = get_dataset(param, get_preprocessing(param))
    jds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param))
    assert ds.node_counts() == jds.node_counts() == [27, 125]
    small, big = ds[0], ds[ds.trajectory_indices(1)[0]]
    assert ds.num_buckets == 2 and small.x.shape[0] < big.x.shape[0]
    assert int(small.node_mask.sum()) == 27 and int(big.node_mask.sum()) == 125
    jsmall = jds[0]
    assert small.x.shape == jsmall.x.shape and ds._bucket_edge_budgets == jds._bucket_edge_budgets


def test_bucketed_worker_loader_matches_in_process(mixed):
    out = subprocess.run(
        [sys.executable, "-m", "tests._torch_port_loader_cases", "buckets", *mixed],
        cwd=ROOT, capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT_S,
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-4000:]


def test_bucketed_fit_and_validation(mixed, tmp_path):
    import shutil

    d = tmp_path / "run"
    d.mkdir()
    shutil.copy(mixed[0], d / "data.h5")
    shutil.copy(mixed[0], d / "test.h5")
    param = _param(str(d / "data.h5"), mixed[1], bucket_multiple=64)
    # without the training noise, whose share of the fixture's tiny
    # per-frame deltas keeps 20 steps from learning much (as
    # test_torch_port_training.py's fit test)
    train_ds = get_dataset(param, get_preprocessing(param, remove_noise=True))
    val_ds = get_dataset(param, get_preprocessing(param, remove_noise=True), switch_to_val=True)
    trainer = Trainer(param, learning_rate=1e-2, warmup=2, checkpoint_dir=str(tmp_path / "ckpt"),
                      metrics_path=None, rollout_dir=str(tmp_path / "meshes"), log_every=100,
                      device="cpu")
    history = trainer.fit(GraphLoader(train_ds, batch_size=2, shuffle=True, prefetch=0),
                          val_dataset=val_ds, num_epochs=2)
    assert history["train_loss"][-1] < history["train_loss"][0]
    assert all(np.isfinite(v) for v in history["val_rmse"])
    preds = trainer.predict(val_ds, save_dir=str(tmp_path / "predictions"))
    # each trajectory padded to its own bucket
    assert [p.shape[1] for p in preds] == [64, 64, 192, 192]
    assert len(list((tmp_path / "predictions").glob("*.xdmf"))) == 4

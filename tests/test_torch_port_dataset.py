"""Port parity, host data for training: ``add_noise`` and the noise step of
the preprocessing, the config's edge layout, and the port's ``H5Dataset`` and
``GraphLoader`` against the JAX ones on the h5 fixture written by
``write_cylinder_h5``: index math, budgets, item features (equal), the
previous-frame data, edges
(equal as sets against the JAX unsorted layout, equal as arrays against its
CSR layout) and the loader's batches."""

import numpy as np
import pytest

from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.dataset import H5Dataset as JaxH5Dataset
from graphphysics_tpu.dataset import preprocessing as jax_pre
from graphphysics_tpu.dataset.sample import RawSample as JaxRawSample
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.utils.synthetic import write_cylinder_h5
from graphphysics_torch.dataset import GraphLoader, H5Dataset, RawSample, add_noise
from graphphysics_torch.training import edge_layout, get_dataset, get_preprocessing
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

NODE_FIELDS = ("x", "pos", "y", "node_mask")


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    # the directory name must not contain "train" (switch_to_val)
    d = tmp_path_factory.mktemp("cyl_data")
    # two mesh sizes: the budgets come from the node-count scan
    h5_path, meta_path = write_cylinder_h5(str(d), grids=[(8, 6), (9, 7)], steps=5)
    return h5_path, meta_path


def _param(h5_path, meta_path, kind="epd", **dataset):
    model = {"type": kind, "message_passing_num": 2, "hidden_size": 16, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3 if kind == "epd" else 0, "num_heads": 4}
    return {
        "dataset": {"extension": "h5", "h5_path": h5_path, "meta_path": meta_path, "khop": 1,
                    **dataset},
        "model": model,
        "index": {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
                  "output_index_end": 2, "node_type_index": 2},
        "transformations": {
            "preprocessing": {"noise": 0.05, "noise_index_start": [0], "noise_index_end": [2]},
            "world_pos_parameters": {"use": False},
        },
    }


def _raw(seed, n=60):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 5)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    return x


@pytest.mark.parametrize(
    "start,end,scale,t",
    [(0, 2, 0.02, None), ([0, 3], [2, 5], [0.1, 0.3], None), (0, 2, 0.02, 0.3)],
)
def test_add_noise_matches_jax(start, end, scale, t):
    x = _raw(0)
    ours = add_noise(RawSample(x=x.copy(), pos=np.zeros((60, 2), np.float32)),
                     np.random.default_rng(7), start, end, scale, node_type_index=2, t=t)
    theirs = jax_pre.add_noise(JaxRawSample(x=x.copy(), pos=np.zeros((60, 2), np.float32)),
                               np.random.default_rng(7), start, end, scale, node_type_index=2, t=t)
    np.testing.assert_array_equal(ours.x, theirs.x)
    normal = x[:, 2] == 0
    assert np.all(ours.x[~normal] == x[~normal]) and np.any(ours.x[normal] != x[normal])


def test_preprocessing_noise_sits_at_position_one(cylinder):
    param = _param(*cylinder)
    ours = get_preprocessing(param)
    theirs = jax_pp.get_preprocessing(param)
    names = [getattr(s, "func", s).__name__ for s in ours.steps]
    assert names == [getattr(s, "func", s).__name__ for s in theirs.steps]
    assert names == ["apply_face_to_edge", "add_noise", "add_edge_features"]
    assert ours.steps[1].keywords == theirs.steps[1].keywords
    assert "add_noise" not in [
        getattr(s, "func", s).__name__ for s in get_preprocessing(param, remove_noise=True).steps
    ]


@pytest.mark.parametrize(
    "kind,config,want",
    [("epd", None, "sorted"), ("epd", "auto", "sorted"), ("epd", "coo", "sorted"),
     ("transformer", None, "csr"), ("transformer", "auto", "csr"), ("transformer", "csr", "csr")],
)
def test_edge_layout_follows_the_model(cylinder, kind, config, want):
    extra = {} if config is None else {"edge_layout": config}
    assert edge_layout(_param(*cylinder, kind, **extra)) == want


def test_edge_layouts_the_port_has_not_raise(cylinder):
    """A layout that is not the model's kernel's raises; the ELL layout,
    dense ops on every device, is taken by both families."""
    with pytest.raises(ValueError, match="does not fit"):
        edge_layout(_param(*cylinder, "epd", edge_layout="csr"))
    for kind in ("epd", "transformer"):
        assert edge_layout(_param(*cylinder, kind, edge_layout="ell")) == "ell"


@pytest.mark.parametrize("kwargs", [{"num_buckets": 2, "bucket_multiple": 16}, {"edge_layout": "ell"}])
def test_unported_dataset_options_raise(cylinder, kwargs):
    """Size buckets and the ELL layout (refused until they were ported) give
    the JAX dataset's padded shapes and edges."""
    h5_path, meta_path = cylinder
    ours = H5Dataset(h5_path, meta_path, node_type_index=2, **kwargs)
    theirs = JaxH5Dataset(h5_path, meta_path, node_type_index=2, **kwargs)
    last = ours.trajectory_indices(1)[0]
    for i in (0, last):
        a, b = ours[i], theirs[i]
        assert a.x.shape == b.x.shape and a.senders.shape == b.senders.shape
        np.testing.assert_array_equal(a.x, b.x)
    if "num_buckets" in kwargs:
        assert ours.num_buckets == theirs.num_buckets == 2
        assert ours[0].x.shape[0] < ours[last].x.shape[0]
    else:
        assert ours.ell_degree == theirs.ell_degree and ours[0].ell_degree == ours.ell_degree
        np.testing.assert_array_equal(ours[0].twin_perm, theirs[0].twin_perm)


def _datasets(cylinder, kind, noise=True):
    param = _param(*cylinder, kind)
    edges = kind == "epd"
    jax_layout = {"edge_layout": "csr"} if kind == "transformer" else {}
    jax_ds = jax_pp.get_dataset(
        param, jax_pp.get_preprocessing(param, use_edge_feature=edges, remove_noise=not noise),
        use_edge_feature=edges, **jax_layout,
    )
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=edges, remove_noise=not noise),
                     use_edge_feature=edges)
    return jax_ds, ds


def _edge_rows(g):
    """The real edges of a graph as a sorted array of rows
    ``(sender, receiver, *edge_attr)``."""
    m = np.asarray(g.edge_mask)
    cols = [np.asarray(g.senders)[m, None], np.asarray(g.receivers)[m, None]]
    if g.edge_attr is not None:
        cols.append(np.asarray(g.edge_attr)[m])
    rows = np.concatenate(cols, axis=1).astype(np.float64)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_items_match_jax(cylinder, kind):
    jax_ds, ds = _datasets(cylinder, kind)
    assert len(ds) == len(jax_ds) == 2 * 4
    assert ds.frames_per_trajectory == jax_ds.frames_per_trajectory
    assert ds.node_counts() == jax_ds.node_counts() == [48, 63]
    for i in range(len(ds)):
        assert ds.get_traj_frame(i) == jax_ds.get_traj_frame(i)
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in (0, 3, 5):
            g, jg = ds[i], jax_ds[i]
            for f in NODE_FIELDS:
                np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(jg, f)), err_msg=f)
            np.testing.assert_array_equal(_edge_rows(g), _edge_rows(jg))
            assert g.num_edges == jg.num_edges
            if kind == "transformer":
                # both sort by sender, stably: the same arrays
                for f in ("senders", "receivers", "edge_mask"):
                    np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(jg, f)))
                assert g.sender_bounds is not None and g.row_bounds is None
            else:
                assert np.all(np.diff(g.receivers[g.edge_mask]) >= 0)
                assert g.row_bounds is not None and g.sender_bounds is None
    assert (ds.node_budget, ds.edge_budget) == (jax_ds.node_budget, jax_ds.edge_budget)
    assert ds.node_budget == 128  # 63 nodes rounded up to bucket_multiple


def test_previous_data_items_match_jax(cylinder):
    """``use_previous_data`` on the h5 path: one frame fewer per trajectory,
    frames offset by one, and each raw sample carrying the previous frame's
    ``x``, equal to the JAX ``H5Dataset``'s on the same file."""
    ds, jax_ds = H5Dataset(*cylinder, use_previous_data=True), JaxH5Dataset(*cylinder,
                                                                              use_previous_data=True)
    assert len(ds) == len(jax_ds) == 2 * 3
    for i in range(len(ds)):
        assert ds.get_traj_frame(i) == jax_ds.get_traj_frame(i) == (i // 3, i % 3 + 1)
        raw, jraw = ds._load(i), jax_ds._load(i)
        for f in ("x", "y", "previous_data"):
            assert np.array_equal(getattr(raw, f), getattr(jraw, f)), f
        # the previous frame is the item before it in the trajectory
        before = H5Dataset(*cylinder)._load(i + i // 3)
        assert np.array_equal(raw.previous_data, before.x)


def test_noise_differs_by_epoch_and_item(cylinder):
    _, ds = _datasets(cylinder, "epd")
    ds.set_epoch(0)
    a = ds[1].x
    ds.set_epoch(1)
    b = ds[1].x
    assert not np.array_equal(a, b)
    _, clean = _datasets(cylinder, "epd", noise=False)
    clean.set_epoch(1)
    c = clean[1].x
    clean.set_epoch(0)
    np.testing.assert_array_equal(clean[1].x, c)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_loader_batches_match_jax(cylinder, kind):
    jax_ds, ds = _datasets(cylinder, kind)
    jax_loader = JaxLoader(jax_ds, batch_size=3, shuffle=True, seed=5, drop_last=True, prefetch=0)
    loader = GraphLoader(ds, batch_size=3, shuffle=True, seed=5)
    assert len(loader) == len(jax_loader) == 2
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        batches, jax_batches = list(loader), list(jax_loader)
        assert len(batches) == len(jax_batches) == len(loader)
        for b, jb in zip(batches, jax_batches):
            for f in NODE_FIELDS:
                np.testing.assert_array_equal(getattr(b, f), np.asarray(getattr(jb, f)), err_msg=f)
            np.testing.assert_array_equal(_edge_rows(b), _edge_rows(jb))
    # peek is the first batch; set_start_batch skips batches of the next epoch only
    loader = GraphLoader(ds, batch_size=2, shuffle=True, seed=5)
    first = loader.peek()
    batches = list(loader)
    np.testing.assert_array_equal(first.x, batches[0].x)
    loader.set_start_batch(2)
    resumed = list(loader)
    assert len(resumed) == len(batches) - 2
    np.testing.assert_array_equal(resumed[0].x, batches[2].x)
    assert len(list(loader)) == len(batches)


def test_partial_last_batch_is_dropped(cylinder):
    _, ds = _datasets(cylinder, "epd")
    loader = GraphLoader(ds, batch_size=3)
    batches = list(loader)  # 8 items: two full batches, the last 2 items dropped
    assert len(batches) == len(loader) == 2
    n, e = ds.node_budget, ds.edge_budget
    for b in batches:
        assert b.num_nodes == 3 * n and b.num_edges == 3 * e
        assert b.node_mask.reshape(3, n).any(axis=1).all()


def test_switch_to_val_reads_the_test_file(cylinder, tmp_path):
    h5_path, meta_path = cylinder
    import shutil

    train = tmp_path / "train.h5"
    shutil.copy(h5_path, train)
    shutil.copy(h5_path, tmp_path / "test.h5")
    ds = H5Dataset(str(train), meta_path, switch_to_val=True)
    assert ds.h5_path == str(tmp_path / "test.h5") and ds.size_dataset == 2
    ds.close()

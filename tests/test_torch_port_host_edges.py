"""Port parity, the dataset's edge and mask options: k-hop edges (cached per
trajectory, with the world-position features when the dataset has them),
random edges and node masking, against the JAX ``H5Dataset`` on one
``write_cylinder_h5`` file and one ``write_plate_press_h5`` file: padded
``x``, ``y``, edges, edge features and ``exclude_mask`` bit for bit, both
packages in the sender-sorted (CSR) layout, and the receiver-sorted layout
against the JAX unsorted one as edge sets. ``get_dataset`` passes the
config's options as the JAX one does. Twins of ``test_dataset.py``'s
``test_khop_increases_edges_and_caches``, ``test_random_edges_add_edges``
and ``test_masking_produces_exclude_mask``."""

import numpy as np
import pytest

from graphphysics_tpu.dataset import H5Dataset as JaxH5Dataset
from graphphysics_tpu.dataset import build_preprocessing as jax_build_preprocessing
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.utils.synthetic import write_cylinder_h5, write_plate_press_h5
from graphphysics_torch.dataset import H5Dataset, build_preprocessing
from graphphysics_torch.training import get_dataset, get_preprocessing
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

GRAPH_FIELDS = ("x", "y", "pos", "node_mask", "senders", "receivers", "edge_attr", "edge_mask",
                "exclude_mask")
WORLD = {"world_pos_index_start": 0, "world_pos_index_end": 3, "node_type_index": 6,
         "radius": 0.08}
PLATE_NOISE = {"noise_index_start": [0], "noise_index_end": [3], "noise_scale": 0.003,
               "node_type_index": 6}
CYLINDER_NOISE = {"noise_index_start": [0], "noise_index_end": [2], "noise_scale": 0.02,
                  "node_type_index": 2}


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    d = tmp_path_factory.mktemp("cyl_edges")
    return write_cylinder_h5(str(d), num_traj=2, steps=5, nx=8, ny=6)


@pytest.fixture(scope="module")
def press(tmp_path_factory):
    d = tmp_path_factory.mktemp("press_edges")
    return write_plate_press_h5(str(d), num_traj=2, steps=10, nx=6, nz=3, seed=1)


def _pair(files, kind, layout="csr", **options):
    """(port dataset, JAX dataset) over one file with the same options: the
    cylinder's noisy pipeline or the press's world-position one."""
    if kind == "cylinder":
        pre, jax_pre = (build_preprocessing(noise_parameters=CYLINDER_NOISE),
                        jax_build_preprocessing(noise_parameters=CYLINDER_NOISE))
        common = dict(node_type_index=2, **options)
    else:
        pre = build_preprocessing(noise_parameters=PLATE_NOISE, world_pos_parameters=WORLD)
        jax_pre = jax_build_preprocessing(noise_parameters=PLATE_NOISE, world_pos_parameters=WORLD)
        common = dict(node_type_index=6, edge_headroom=2.0, **options)
    ds = H5Dataset(*files, preprocessing=pre, edge_layout=layout, **common)
    jax_ds = JaxH5Dataset(*files, preprocessing=jax_pre,
                          edge_layout="csr" if layout == "csr" else "coo", **common)
    return ds, jax_ds


def _edge_rows(g):
    m = np.asarray(g.edge_mask)
    cols = [np.asarray(g.senders)[m, None], np.asarray(g.receivers)[m, None]]
    if g.edge_attr is not None:
        cols.append(np.asarray(g.edge_attr)[m])
    rows = np.concatenate(cols, axis=1).astype(np.float64)
    return rows[np.lexsort(rows.T[::-1])]


def _assert_items_equal(ds, jax_ds, indices, epochs=(0, 1), exact=True):
    for epoch in epochs:
        ds.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in indices:
            g, jg = ds[i], jax_ds[i]
            fields = GRAPH_FIELDS if exact else ("x", "y", "pos", "node_mask", "exclude_mask")
            for f in fields:
                a, b = getattr(g, f), getattr(jg, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{f} item {i}")
            if not exact:
                np.testing.assert_array_equal(_edge_rows(g), _edge_rows(jg))
    assert (ds.node_budget, ds.edge_budget) == (jax_ds.node_budget, jax_ds.edge_budget)


OPTIONS = {
    "khop2": {"khop": 2},
    "khop3": {"khop": 3},
    "random_edges": {"new_edges_ratio": 0.2, "edge_headroom": 1.5},
    "masking": {"masking_ratio": 0.25},
    "all": {"khop": 2, "new_edges_ratio": 0.1, "masking_ratio": 0.5, "edge_headroom": 1.5},
}


@pytest.mark.parametrize("layout", ["csr", "sorted"])
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_cylinder_items_match_jax(cylinder, name, layout):
    ds, jax_ds = _pair(cylinder, "cylinder", layout, **OPTIONS[name])
    _assert_items_equal(ds, jax_ds, (0, 1, 4, 7), exact=layout == "csr")


@pytest.mark.parametrize(
    "options",
    [{}, {"khop": 2, "world_pos_parameters": WORLD}, {"new_edges_ratio": 0.3},
     {"masking_ratio": 0.4}],
    ids=["world", "khop2_world", "random_edges", "masking"],
)
def test_press_items_match_jax(press, options):
    """The world-position pipeline with each option; with k-hop the edge
    features are recomputed with the world-position ones on the first item
    of a trajectory built, and later items reuse them (the reference's
    cache)."""
    ds, jax_ds = _pair(press, "plate", **options)
    _assert_items_equal(ds, jax_ds, (0, 5, 3, 12, 17))
    if "khop" in options:
        assert ds[0].edge_attr.shape[1] == 8
        assert sorted(ds._khop_edges_cache) == sorted(jax_ds._khop_edges_cache) == [0, 1]


def test_khop_increases_edges_and_caches(cylinder):
    base = H5Dataset(*cylinder, preprocessing=build_preprocessing(), node_type_index=2)
    ds = H5Dataset(*cylinder, preprocessing=build_preprocessing(), khop=2, node_type_index=2)
    e1, e2 = int(base[0].edge_mask.sum()), int(ds[0].edge_mask.sum())
    assert e2 > e1
    assert 0 in ds._khop_edges_cache
    # the trajectory's next item reuses the cache
    assert int(ds[1].edge_mask.sum()) == e2
    assert ds._khop_edges_cache[0][0] is ds._khop_edges_cache[0][0]


def test_random_edges_add_edges(cylinder):
    base = H5Dataset(*cylinder, preprocessing=build_preprocessing(), node_type_index=2)
    aug = H5Dataset(*cylinder, preprocessing=build_preprocessing(), new_edges_ratio=0.2,
                    node_type_index=2, edge_headroom=1.5)
    assert int(aug[0].edge_mask.sum()) > int(base[0].edge_mask.sum())
    # a new draw per epoch
    first = aug[0].senders.copy()
    aug.set_epoch(1)
    assert not np.array_equal(aug[0].senders, first)


def test_masking_produces_exclude_mask(cylinder):
    """The reference's MeshMask semantics: ``int((1 - ratio) * N)`` real
    nodes are marked, the padding never."""
    ds = H5Dataset(*cylinder, preprocessing=build_preprocessing(), masking_ratio=0.25,
                   node_type_index=2)
    g = ds[0]
    n = int(g.node_mask.sum())
    assert g.exclude_mask is not None and g.exclude_mask.shape == g.node_mask.shape
    assert int(g.exclude_mask.sum()) == int(0.75 * n)
    assert not g.exclude_mask[n:].any()
    assert H5Dataset(*cylinder, preprocessing=build_preprocessing(),
                     node_type_index=2)[0].exclude_mask is None


def _config(files, kind, **dataset):
    if kind == "cylinder":
        model = {"type": "epd", "message_passing_num": 2, "hidden_size": 16, "node_input_size": 2,
                 "output_size": 2, "edge_input_size": 3}
        index = {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
                 "output_index_end": 2, "node_type_index": 2}
        world = {"use": False}
    else:
        model = {"type": "transformer", "message_passing_num": 2, "hidden_size": 16,
                 "node_input_size": 6, "output_size": 3, "edge_input_size": 0, "num_heads": 4}
        index = {"feature_index_start": 0, "feature_index_end": 6, "output_index_start": 0,
                 "output_index_end": 3, "node_type_index": 6}
        world = {"use": True, "world_pos_index_start": 0, "world_pos_index_end": 3, "radius": 0.08}
    return {
        "dataset": {"extension": "h5", "h5_path": files[0], "meta_path": files[1], **dataset},
        "model": model,
        "index": index,
        "transformations": {"preprocessing": {"noise": 0.01, "noise_index_start": [0],
                                              "noise_index_end": [2]},
                            "world_pos_parameters": world},
    }


@pytest.mark.parametrize("khop", [1, 2])
def test_get_dataset_passes_the_options_as_jax_does(press, khop):
    """The config's ``khop`` and ``new_edges_ratio`` and the caller's
    ``masking_ratio`` reach the dataset; the world-position parameters
    only with ``khop > 1``. The items equal the JAX ``get_dataset``'s."""
    param = _config(press, "plate", khop=khop, new_edges_ratio=0.1, edge_headroom=2.0)
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=True), masking_ratio=0.3)
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=True),
                                masking_ratio=0.3, edge_layout="csr")
    assert (ds.khop, ds.new_edges_ratio, ds.masking_ratio) == (khop, 0.1, 0.3)
    want = 0 if khop > 1 else None
    assert ds.world_pos_index_start == jax_ds.world_pos_index_start == want
    _assert_items_equal(ds, jax_ds, (0, 9), epochs=(0,))


def test_cylinder_config_with_every_option_matches_jax(cylinder):
    param = _config(cylinder, "cylinder", khop=2, new_edges_ratio=0.2, edge_headroom=1.5)
    ds = get_dataset(param, get_preprocessing(param), masking_ratio=0.5)
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param), masking_ratio=0.5)
    assert ds.edge_layout == "sorted"
    _assert_items_equal(ds, jax_ds, (0, 3, 6), exact=False)

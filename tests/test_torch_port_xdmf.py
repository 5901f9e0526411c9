"""Port parity, the XDMF data path: the same files, written by the JAX
package's ``write_aneurysm_xdmf`` (tetrahedra) and ``write_panels_xdmf``
(triangles), read by both ``XDMFDataset``s with a random horizon
(``random_next=3``, ``random_prev=2``) over two epochs: the raw samples and
the padded CSR graphs equal; the port's writers against the JAX ones;
``switch_to_val`` rewriting the last ``train`` of the path only;
``scan_node_counts`` from the metadata; the missing-dynamic-field error;
and inline-XML files (``chip_fidelity.write_inline_xdmf``, the card's
format) read by both readers equal to the HDF originals."""

import json
import os

import numpy as np
import pytest

import chip_fidelity
from graphphysics_tpu.dataset.xdmf_dataset import XDMFDataset as JaxXDMFDataset
from graphphysics_tpu.external.aneurysm import build_features as jax_build_features
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.utils.synthetic import write_aneurysm_xdmf as jax_write_aneurysm
from graphphysics_tpu.utils.synthetic import write_panels_xdmf as jax_write_panels
from graphphysics_tpu.utils.xdmf import XdmfTimeSeriesReader as JaxReader
from graphphysics_torch.dataset import XDMFDataset
from graphphysics_torch.external import build_features
from graphphysics_torch.training import get_dataset, get_preprocessing
from graphphysics_torch.utils import synthetic
from graphphysics_torch.utils.xdmf import XdmfTimeSeriesReader
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

STEPS = 7
RAW_ARRAYS = ("x", "y", "pos", "faces", "tetra")
RAW_SCALARS = ("target_dt", "previous_dt", "id", "traj_index")
GRAPH_FIELDS = ("x", "pos", "y", "node_mask", "senders", "receivers", "edge_mask")


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Both schemas written by the JAX package under ``.../train`` (the
    aneurysm one with two mesh sizes), and a ``.../test`` split of each."""
    root = tmp_path_factory.mktemp("xdmf_data")
    out = {}
    for name, write, kw in (
        ("aneurysm", jax_write_aneurysm, {"sizes": [4, 5]}),
        ("panels", jax_write_panels, {"num_traj": 2, "nx": 8, "ny": 6}),
    ):
        folder, meta_path = write(str(root / name / "train"), steps=STEPS, **kw)
        write(str(root / name / "test"), steps=STEPS, seed=3, **kw)
        out[name] = (folder, meta_path)
    return out


def _param(schema, folder, meta_path, **dataset):
    """A transformer config on ``folder``: coarse-aneurysm's layout (its
    noise, node type at 14) or panels' (node type at 3)."""
    aneurysm = schema == "aneurysm"
    noise = ({"noise": [0.02, 0.02, 0.02, 0.01, 0.01, 0.01],
              "noise_index_start": [0, 1, 2, 5, 6, 7], "noise_index_end": [1, 2, 3, 6, 7, 8]}
             if aneurysm else {"noise": 0.02, "noise_index_start": [0], "noise_index_end": [2]})
    return {
        "dataset": {"extension": "xdmf", "xdmf_folder": folder, "meta_path": meta_path,
                    "khop": 1, **dataset},
        "model": {"type": "transformer", "message_passing_num": 2, "hidden_size": 16,
                  "node_input_size": 14 if aneurysm else 2, "output_size": 3,
                  "edge_input_size": 0, "num_heads": 4},
        "index": {"feature_index_start": 0, "feature_index_end": 14 if aneurysm else 2,
                  "output_index_start": 0, "output_index_end": 3,
                  "node_type_index": 14 if aneurysm else 3},
        "transformations": {"preprocessing": noise, "world_pos_parameters": {"use": False}},
    }


def _dataset_pair(schema, folder, meta_path, previous=True, dt_features=False, val=False):
    param = _param(schema, folder, meta_path, random_next=3, random_prev=2,
                   dt_features=dt_features)
    hooks = (build_features, jax_build_features) if schema == "aneurysm" else (None, None)
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=False, remove_noise=val,
                                              extra_node_features=hooks[0]),
                     use_edge_feature=False, use_previous_data=previous, switch_to_val=val)
    jax_ds = jax_pp.get_dataset(
        param, jax_pp.get_preprocessing(param, use_edge_feature=False, remove_noise=val,
                                        extra_node_features=hooks[1]),
        use_edge_feature=False, use_previous_data=previous, switch_to_val=val, edge_layout="csr")
    return ds, jax_ds


def _assert_raw_equal(a, b):
    for f in RAW_ARRAYS:
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)
    for f in RAW_SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    if b.previous_data is None:
        assert a.previous_data is None
    else:
        assert list(a.previous_data) == list(b.previous_data)
        for k, v in b.previous_data.items():
            np.testing.assert_array_equal(a.previous_data[k], v, err_msg=k)


@pytest.mark.parametrize("schema,previous,dt_features", [
    ("aneurysm", True, False), ("aneurysm", True, True), ("panels", True, True),
    ("panels", False, False),
])
def test_raw_samples_and_graphs_match_jax(folders, schema, previous, dt_features):
    """Every item of both epochs: the raw sample (``_load``) and the padded
    CSR graph equal. Both packages run the same numpy arithmetic on the same
    draws (the horizon, the noise), so the arrays are equal, not close."""
    ds, jax_ds = _dataset_pair(schema, *folders[schema], previous=previous,
                               dt_features=dt_features)
    assert len(ds) == len(jax_ds) == 2 * (STEPS - 1 - int(previous))
    assert [ds.get_traj_frame(i) for i in range(len(ds))] == \
        [jax_ds.get_traj_frame(i) for i in range(len(jax_ds))]
    offsets = set()
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(len(ds)):
            raw, jraw = ds._load(i), jax_ds._load(i)
            _assert_raw_equal(raw, jraw)
            offsets.add((raw.target_dt, raw.previous_dt))
            g, jg = ds[i], jax_ds[i]
            for f in GRAPH_FIELDS:
                np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(jg, f)),
                                              err_msg=f"{f} item {i} epoch {epoch}")
            assert g.sender_bounds is not None
    assert len(offsets) > 1  # the horizon was drawn, not fixed at 1
    assert (ds.node_budget, ds.edge_budget) == (jax_ds.node_budget, jax_ds.edge_budget)


def test_tetra_sample_keeps_cells_and_faces(folders):
    ds, _ = _dataset_pair("aneurysm", *folders["aneurysm"])
    raw = ds._load(0)
    assert raw.tetra.shape == (6 * 3 ** 3, 4) and raw.faces.shape == (4 * 6 * 3 ** 3, 3)
    assert raw.id == "0" and raw.previous_dt in (-0.01, -0.02) and raw.target_dt in (0.01, 0.02, 0.03)
    g = ds[0]
    n = int(g.node_mask.sum())
    assert n == 64 and g.x.shape[1] == 15  # [Vitesse, wall, time, accel, pos, stats, node type]


@pytest.mark.parametrize("schema", ["aneurysm", "panels"])
def test_switch_to_val_matches_jax(folders, schema):
    ds, jax_ds = _dataset_pair(schema, *folders[schema], val=True)
    assert ds.xdmf_folder == jax_ds.xdmf_folder and ds.xdmf_folder.endswith(os.sep + "test")
    assert (ds.random_next, ds.random_prev) == (jax_ds.random_next, jax_ds.random_prev) == (1, 1)
    for i in (0, len(ds) - 1):
        _assert_raw_equal(ds._load(i), jax_ds._load(i))


def test_switch_to_val_rewrites_the_last_train_only(tmp_path):
    base = tmp_path / "train_runs" / "train"
    folder, meta_path = jax_write_aneurysm(str(base), num_traj=1, steps=3, n=2)
    jax_write_aneurysm(str(tmp_path / "train_runs" / "test"), num_traj=1, steps=3, n=2)
    ds = XDMFDataset(folder, meta_path, switch_to_val=True, random_next=3, random_prev=2)
    jax_ds = JaxXDMFDataset(folder, meta_path, switch_to_val=True, random_next=3, random_prev=2)
    assert ds.xdmf_folder == jax_ds.xdmf_folder == str(tmp_path / "train_runs" / "test")
    assert (ds.random_next, ds.random_prev) == (1, 1)


def test_scan_node_counts_reads_metadata_only(folders, monkeypatch):
    folder, meta_path = folders["aneurysm"]
    ds = XDMFDataset(folder, meta_path)
    jax_ds = JaxXDMFDataset(folder, meta_path)

    def no_heavy_data(self, item):
        raise AssertionError("scan_node_counts read an array")

    monkeypatch.setattr(XdmfTimeSeriesReader, "_read_data_item", no_heavy_data)
    assert ds.scan_node_counts() == jax_ds.scan_node_counts() == [64, 125]


def test_missing_dynamic_field_raises():
    meta = {"features": {"Vitesse": {"type": "dynamic", "dtype": "float32"},
                         "cells": {"type": "static", "dtype": "int32"}}}
    ds, jax_ds = XDMFDataset.__new__(XDMFDataset), JaxXDMFDataset.__new__(JaxXDMFDataset)
    ds.meta = jax_ds.meta = meta
    out = ds._filter_features({"Vitesse": np.zeros((4, 2))})
    assert list(out) == list(jax_ds._filter_features({"Vitesse": np.zeros((4, 2))})) == ["Vitesse"]
    assert out["Vitesse"].dtype == np.float32
    for d in (ds, jax_ds):
        with pytest.raises(KeyError, match="Vitesse"):
            d._filter_features({"somethingelse": np.zeros(4)})


def _read_all(reader_cls, path):
    with reader_cls(path) as r:
        points, cells = r.read_points_cells()
        frames = [r.read_data(k)[:2] for k in range(r.num_steps)]
        return points, cells, frames, r.num_points()


def _assert_files_equal(a, b):
    (pa, ca, fa, na), (pb, cb, fb, nb) = a, b
    np.testing.assert_array_equal(pa, pb)
    assert pa.dtype == pb.dtype and na == nb and len(fa) == len(fb)
    assert ca[0][0] == cb[0][0]
    np.testing.assert_array_equal(ca[0][1], cb[0][1])
    for (ta, da), (tb, db) in zip(fa, fb):
        assert ta == tb and list(da) == list(db)
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("schema", ["aneurysm", "panels"])
def test_port_writers_match_jax(tmp_path, schema):
    """``write_aneurysm_xdmf`` / ``write_panels_xdmf`` of the port write what
    the JAX package's write (seeded conditions, two mesh sizes for the
    aneurysm): the same files, read back equal, and the same meta."""
    if schema == "aneurysm":
        kw = {"sizes": [3, 4], "steps": 4, "seed": 5}
        ours, theirs = synthetic.write_aneurysm_xdmf, jax_write_aneurysm
        names = ["mesh_0.xdmf", "mesh_1.xdmf"]
    else:
        kw = {"num_traj": 2, "steps": 4, "nx": 5, "ny": 4, "seed": 5}
        ours, theirs = synthetic.write_panels_xdmf, jax_write_panels
        names = ["panel_0.xdmf", "panel_1.xdmf"]
    _, meta = ours(str(tmp_path / "port"), **kw)
    _, jax_meta = theirs(str(tmp_path / "jax"), **kw)
    assert json.load(open(meta)) == json.load(open(jax_meta))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for name in names:
        _assert_files_equal(_read_all(JaxReader, str(tmp_path / "port" / name)),
                            _read_all(JaxReader, str(tmp_path / "jax" / name)))


def test_inline_files_read_equal_to_hdf_originals(tmp_path):
    """The card's inline-XML aneurysm folder (``write_aneurysm_inline``)
    against ``write_aneurysm_xdmf``'s HDF one of the same trajectories: each
    reader gives equal arrays from both, and both XDMFDatasets equal
    samples."""
    hdf, meta = jax_write_aneurysm(str(tmp_path / "hdf"), num_traj=2, steps=4, n=3, seed=9)
    inline, inline_meta = chip_fidelity.write_aneurysm_inline(str(tmp_path / "inline"), 2, 4, 3,
                                                              seed=9)
    assert json.load(open(meta)) == json.load(open(inline_meta))
    with open(os.path.join(inline, "mesh_0.xdmf")) as fp:
        assert 'Format="XML"' in fp.read() and not os.path.exists(os.path.join(inline, "mesh_0.h5"))
    for name in ("mesh_0.xdmf", "mesh_1.xdmf"):
        original = _read_all(JaxReader, os.path.join(hdf, name))
        for reader in (JaxReader, XdmfTimeSeriesReader):
            _assert_files_equal(_read_all(reader, os.path.join(inline, name)), original)
    kw = dict(use_previous_data=True, random_next=2, random_prev=2)
    for a, b in ((XDMFDataset(inline, inline_meta, **kw), XDMFDataset(hdf, meta, **kw)),
                 (JaxXDMFDataset(inline, inline_meta, **kw), JaxXDMFDataset(hdf, meta, **kw))):
        for i in range(len(a)):
            _assert_raw_equal(a._load(i), b._load(i))

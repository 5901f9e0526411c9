"""Port twins of the JAX utility tests: the metric meter and the CSV
logger's header growth and resume, the TTY-only progress line, and the XDMF
time series (typed, gzip-compressed DataItems; a colon in the file name;
the node count without the heavy data), with files crossing between the two
packages' writers and readers."""

import csv
import io
import os
import xml.etree.ElementTree as ET

import h5py
import numpy as np
import pytest

from graphphysics_tpu.utils.metrics import CSVMetricsLogger as JaxCSVLogger
from graphphysics_tpu.utils.xdmf import XdmfTimeSeriesReader as JaxReader
from graphphysics_tpu.utils.xdmf import XdmfTimeSeriesWriter as JaxWriter
from graphphysics_torch.utils import (
    AverageValueMeter,
    CSVMetricsLogger,
    ProgressReporter,
    WandbLogger,
    XdmfTimeSeriesReader,
    XdmfTimeSeriesWriter,
)
from graphphysics_torch.utils.synthetic import triangulated_grid
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)


def test_average_value_meter(rng):
    m = AverageValueMeter()
    vals = rng.normal(size=100)
    for v in vals:
        m.add(float(v))
    mean, std = m.value()
    np.testing.assert_allclose(mean, vals.mean(), rtol=1e-6)
    np.testing.assert_allclose(std, vals.std(ddof=1), rtol=1e-5)


def _rows(path):
    with open(path, newline="") as f:
        return [{k: v for k, v in r.items() if k != "time"} for r in csv.DictReader(f)]


def test_csv_logger_header_growth_and_resume(tmp_path):
    path = str(tmp_path / "m.csv")
    log = CSVMetricsLogger(path)
    log.log(0, 1, {"train_loss": 1.0})
    log.log(0, 2, {"train_loss": 0.9, "val_rmse": 0.5})  # header widens
    rows = _rows(path)
    assert rows[0]["train_loss"] == "1.0"
    assert rows[0]["val_rmse"] == ""  # the earlier row under the new header
    assert rows[1]["val_rmse"] == "0.5"
    # resume: a fresh logger adopts the existing header, written once
    CSVMetricsLogger(path).log(1, 3, {"train_loss": 0.8})
    with open(path) as f:
        lines = f.read().strip().splitlines()
    assert sum(1 for line in lines if line.startswith("time,")) == 1
    rows = _rows(path)
    assert len(rows) == 3 and rows[2]["epoch"] == "1"
    # the JAX logger writes the same file
    jax_path = str(tmp_path / "jax.csv")
    jax_log = JaxCSVLogger(jax_path)
    jax_log.log(0, 1, {"train_loss": 1.0})
    jax_log.log(0, 2, {"train_loss": 0.9, "val_rmse": 0.5})
    JaxCSVLogger(jax_path).log(1, 3, {"train_loss": 0.8})
    assert _rows(jax_path) == rows


def test_wandb_logger_with_a_stand_in_module(monkeypatch):
    """A run that starts logs through it and keeps its id; one that cannot
    start leaves the logger off. wandb itself is replaced by a stand-in."""
    import sys
    import types

    logged = []

    class Run:
        id = "run-1"

        def log(self, metrics, step=None):
            logged.append((metrics, step))

    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: Run()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    on = WandbLogger(project="p", run_id="run-1")
    on.log({"train_loss": 1.0}, step=3)
    assert on.run_id == "run-1" and logged == [({"train_loss": 1.0}, 3)]

    def refuse(**kw):
        raise RuntimeError("no run")

    fake.init = refuse
    off = WandbLogger(project="p")
    off.log({"train_loss": 1.0}, step=4)
    assert off.run is None and off.run_id is None and len(logged) == 1


class _Tty(io.StringIO):
    def isatty(self):
        return True


def test_progress_off_on_a_non_tty_stream():
    buf = io.StringIO()
    p = ProgressReporter(10, prefix="epoch 0", stream=buf)
    for i in range(1, 11):
        p.update(i, loss=0.5)
    p.close()
    assert buf.getvalue() == ""


def test_progress_renders_on_a_tty_throttles_and_clears():
    buf = _Tty()
    p = ProgressReporter(3, prefix="epoch 1", stream=buf, min_interval=0.0)
    p.update(1)
    p.update(3, loss=0.25)
    out = buf.getvalue()
    assert "epoch 1" in out and "1/3" in out and "3/3" in out
    assert "loss=0.25" in out and "it/s" in out
    p.close()
    assert buf.getvalue().endswith("\r")
    buf = _Tty()
    p = ProgressReporter(100, stream=buf, min_interval=3600.0)
    p.update(1)
    mid = buf.getvalue()
    p.update(50)
    assert buf.getvalue() == mid  # throttled
    p.update(100)  # the last count is always written
    assert "100/100" in buf.getvalue()
    buf = io.StringIO()
    ProgressReporter(None, stream=buf, enable=True, min_interval=0.0).update(7)
    assert "7" in buf.getvalue()


@pytest.mark.parametrize("writer", [XdmfTimeSeriesWriter, JaxWriter], ids=["port", "jax"])
def test_xdmf_dataitems_typed_and_compressed(tmp_path, rng, writer):
    """DataItems carry DataType, NumberType and Precision, heavy data is
    gzip-compressed, and the two packages write the same file."""
    points, tris = triangulated_grid(4, 3)
    values = rng.normal(size=(len(points),))
    path = str(tmp_path / "typed.xdmf")
    with writer(path) as w:
        w.write_points_cells(points.astype(np.float64), tris)
        w.write_data(0.0, {"v": values})
    root = ET.parse(path).getroot()
    items = list(root.iter("DataItem"))
    assert items
    for it in items:
        assert it.get("Precision") == "8"
        assert it.get("DataType") in ("Float", "Int")
        assert it.get("NumberType") == it.get("DataType")
    assert root.find(".//Topology/DataItem").get("DataType") == "Int"
    with h5py.File(str(tmp_path / "typed.h5")) as f:
        assert f["data0"].compression == "gzip"
    other = str(tmp_path / "other.xdmf")
    with (JaxWriter if writer is XdmfTimeSeriesWriter else XdmfTimeSeriesWriter)(other) as w:
        w.write_points_cells(points.astype(np.float64), tris)
        w.write_data(0.0, {"v": values})
    with open(path) as a, open(other) as b:
        assert a.read().replace("typed.h5", "other.h5") == b.read()


@pytest.mark.parametrize("reader", [XdmfTimeSeriesReader, JaxReader], ids=["port", "jax"])
def test_xdmf_reader_handles_colon_in_h5_filename(tmp_path, rng, reader):
    """'name.h5:/dataN' splits on the last colon, so a file named like
    'run:12.h5' resolves; the port's files read in both readers."""
    points, tris = triangulated_grid(4, 3)
    path = str(tmp_path / "run:12.xdmf")
    v = rng.normal(size=(len(points),))
    with XdmfTimeSeriesWriter(path) as w:
        w.write_points_cells(points, tris)
        w.write_data(0.0, {"v": v})
        w.write_data(0.5, {"v": 2 * v})
    with reader(path) as r:
        assert r.num_points() == len(points) and r.num_steps == 2
        got_points, cells = r.read_points_cells()
        np.testing.assert_array_equal(got_points, points.astype(np.float64))
        assert cells[0][0] == "triangle"
        np.testing.assert_array_equal(cells[0][1], tris)
        t, pd, _ = r.read_data(1)
        assert t == 0.5
        np.testing.assert_allclose(pd["v"], 2 * v)


def test_xdmf_num_points_metadata_only(tmp_path, rng):
    """num_points comes from the geometry's Dimensions attribute, without
    reading the heavy file."""
    points, tris = triangulated_grid(6, 5)
    path = str(tmp_path / "np.xdmf")
    with JaxWriter(path) as w:
        w.write_points_cells(points, tris)
        w.write_data(0.0, {"v": rng.normal(size=(len(points),))})
    with XdmfTimeSeriesReader(path) as r:
        os.rename(str(tmp_path / "np.h5"), str(tmp_path / "np.h5.bak"))
        try:
            assert r.num_points() == len(points)
        finally:
            os.rename(str(tmp_path / "np.h5.bak"), str(tmp_path / "np.h5"))

"""Port twins of ``tests/test_export_viz.py``: the port's mesh export
(``graphphysics_torch/utils/mesh_export.py``: VTU write and read in every
flavor, a VTU series to XDMF), its visualization and its XDMF files, each
case as the JAX package's test holds its own; then the port's VTU files and
mesh data against the JAX functions' on the same numpy inputs, and a
``Trainer``'s ``plot_callback``."""

import os

import numpy as np
import pytest

from graphphysics_torch.core.graph import pad_graph_np
from graphphysics_torch.utils.mesh_export import (
    graph_to_meshdata,
    read_vtu,
    vtu_series_to_xdmf,
    write_vtu,
)
from graphphysics_torch.utils.visualization import render_field_image
from graphphysics_torch.utils.xdmf import XdmfTimeSeriesReader
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)
from tests.fixtures import triangulated_grid


def make_test_graph(n=48, e=160, n_pad=64, e_pad=192, seed=0):
    """``tests/conftest.make_test_graph`` as a port Graph of tensors."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = rng.integers(0, 7, size=n)
    return pad_graph_np(
        x, rng.normal(size=(n, 2)).astype(np.float32),
        rng.integers(0, n, size=e).astype(np.int32), rng.integers(0, n, size=e).astype(np.int32),
        n_pad=n_pad, e_pad=e_pad, edge_attr=rng.normal(size=(e, 3)).astype(np.float32),
        y=rng.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
    ).to("cpu")


def test_vtu_roundtrip(tmp_path, rng):
    points, tris = triangulated_grid(6, 5)
    pd = {"v": rng.normal(size=(len(points),)), "vec": rng.normal(size=(len(points), 2))}
    p = str(tmp_path / "m.vtu")
    write_vtu(p, points, tris, pd)
    pts2, cells2, pd2 = read_vtu(p)
    np.testing.assert_allclose(pts2[:, :2], points, rtol=1e-6)
    np.testing.assert_array_equal(cells2, tris)
    np.testing.assert_allclose(pd2["v"], pd["v"], rtol=1e-6)
    np.testing.assert_allclose(pd2["vec"], pd["vec"], rtol=1e-6)


def test_graph_to_meshdata_unpads():
    g = make_test_graph()
    points, tris = triangulated_grid(8, 6)  # 48 = n real nodes
    pts, cells, pd = graph_to_meshdata(g, tris)
    assert len(pts) == 48
    assert "x0" in pd and "y0" in pd
    assert len(pd["x0"]) == 48


def test_vtu_series_to_xdmf(tmp_path, rng):
    points, tris = triangulated_grid(5, 4)
    paths = []
    for t in range(3):
        p = str(tmp_path / f"f{t}.vtu")
        write_vtu(p, points, tris, {"v": rng.normal(size=(len(points),))})
        paths.append(p)
    out = str(tmp_path / "series.xdmf")
    vtu_series_to_xdmf(paths, out, dt=0.5)
    with XdmfTimeSeriesReader(out) as r:
        assert r.num_steps == 3
        t, pd, _ = r.read_data(2)
        assert t == 1.0 and "v" in pd


def test_render_field_image(tmp_path, rng):
    points, tris = triangulated_grid(6, 5)
    p = render_field_image(
        points, tris, rng.normal(size=(len(points),)),
        str(tmp_path / "f.png"), title="t",
    )
    assert os.path.exists(p) and os.path.getsize(p) > 1000


def _tetra_box(nx=4, ny=4, nz=4):
    """Regular box of tetrahedra (5 per cube) for 3D rendering tests."""
    import numpy as np

    idx = lambda x, y, z: (z * ny + y) * nx + x  # noqa: E731
    pts = np.array(
        [[x, y, z] for z in range(nz) for y in range(ny) for x in range(nx)],
        dtype=np.float32,
    )
    tets = []
    for z in range(nz - 1):
        for y in range(ny - 1):
            for x in range(nx - 1):
                v = [idx(x + dx, y + dy, z + dz)
                     for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
                if (x + y + z) % 2:
                    # mirror odd-parity cubes so diagonal faces CONFORM with
                    # neighbors (else interior faces read as boundary)
                    v = [v[1], v[0], v[3], v[2], v[5], v[4], v[7], v[6]]
                # 5-tet decomposition of the cube [v0..v7]
                tets += [
                    [v[0], v[1], v[3], v[5]],
                    [v[0], v[3], v[2], v[6]],
                    [v[0], v[5], v[6], v[4]],
                    [v[3], v[5], v[6], v[7]],
                    [v[0], v[3], v[5], v[6]],
                ]
    return pts, np.asarray(tets, np.int64)


def test_tetra_boundary_faces_box():
    """Boundary extraction: faces used by exactly one tetrahedron — for the
    5-tet box every boundary face lies on the box surface."""
    import numpy as np

    from graphphysics_torch.topology import tetra_boundary_faces

    pts, tets = _tetra_box()
    b = tetra_boundary_faces(tets)
    assert len(b) > 0
    # every boundary face has all 3 nodes on some box face plane
    on_surface = 0
    for f in b:
        p = pts[f]
        for d in range(3):
            if np.ptp(p[:, d]) == 0 and p[0, d] in (0.0, 3.0):
                on_surface += 1
                break
    assert on_surface == len(b)


def test_render_field_image_3d(tmp_path, rng):
    """3D tetra meshes render as a depth-sorted boundary surface (the
    reference's PyVista-screenshot role, callback.py:38-84)."""
    pts, tets = _tetra_box()
    p = render_field_image(
        pts, tets, rng.normal(size=(len(pts),)),
        str(tmp_path / "f3d.png"), title="3d",
    )
    assert os.path.exists(p) and os.path.getsize(p) > 1000


def test_render_rollout_gif_3d(tmp_path, rng):
    from graphphysics_torch.utils.visualization import render_rollout_gif

    pts, tets = _tetra_box(3, 3, 3)
    frames = rng.normal(size=(3, len(pts)))
    p = render_rollout_gif(
        pts, tets, frames, str(tmp_path / "r3d.gif"), title="3d"
    )
    assert os.path.exists(p) and os.path.getsize(p) > 1000


@pytest.mark.parametrize("fmt", ["binary", "compressed"])
def test_vtu_binary_roundtrip(tmp_path, rng, fmt):
    """Inline base64 binary and zlib-compressed VTU flavors round-trip
    EXACTLY (no ASCII float truncation)."""
    points, tris = triangulated_grid(6, 5)
    pd_in = {
        "v": rng.normal(size=(len(points),)),
        "vec": rng.normal(size=(len(points), 2)),
    }
    p = str(tmp_path / f"f_{fmt}.vtu")
    write_vtu(p, points, tris, pd_in, format=fmt)
    pts, cells, pd = read_vtu(p)
    np.testing.assert_array_equal(pts[:, :2], points)
    np.testing.assert_array_equal(cells, tris)
    np.testing.assert_array_equal(pd["v"], pd_in["v"])  # bit-exact
    np.testing.assert_array_equal(pd["vec"], pd_in["vec"])


def test_vtu_appended_base64(tmp_path, rng):
    """Base64 AppendedData VTU (meshio's whole-blob convention, byte
    offsets in the decoded stream) reads back exactly."""
    import base64
    import xml.etree.ElementTree as ET

    points, tris = triangulated_grid(5, 4)
    v = rng.normal(size=(len(points),))

    blob = b""
    offsets = {}

    def put(name, arr):
        nonlocal blob
        raw = np.ascontiguousarray(arr).tobytes()
        offsets[name] = len(blob)
        blob += np.array([len(raw)], "<u8").tobytes() + raw

    pts3 = np.hstack([points, np.zeros((len(points), 1))]).astype("<f8")
    put("Points", pts3)
    put("connectivity", tris.astype("<i8"))
    put("offsets", (np.arange(1, len(tris) + 1) * 3).astype("<i8"))
    put("types", np.full(len(tris), 5, "<u1"))
    put("v", v.astype("<f8"))

    root = ET.Element("VTKFile", type="UnstructuredGrid",
                      byte_order="LittleEndian", header_type="UInt64")
    ug = ET.SubElement(root, "UnstructuredGrid")
    piece = ET.SubElement(ug, "Piece", NumberOfPoints=str(len(points)),
                          NumberOfCells=str(len(tris)))

    def da(parent, name, vtk_type, ncomp=None):
        d = ET.SubElement(parent, "DataArray", type=vtk_type, Name=name,
                          Format="appended", offset=str(offsets[name]))
        if ncomp:
            d.set("NumberOfComponents", str(ncomp))

    da(ET.SubElement(piece, "Points"), "Points", "Float64", 3)
    cl = ET.SubElement(piece, "Cells")
    da(cl, "connectivity", "Int64")
    da(cl, "offsets", "Int64")
    da(cl, "types", "UInt8")
    da(ET.SubElement(piece, "PointData"), "v", "Float64")
    app = ET.SubElement(root, "AppendedData", encoding="base64")
    app.text = "_" + base64.b64encode(blob).decode()
    p = str(tmp_path / "appended.vtu")
    ET.ElementTree(root).write(p)

    pts, cells, pd = read_vtu(p)
    np.testing.assert_array_equal(pts[:, :2], points)
    np.testing.assert_array_equal(cells, tris)
    np.testing.assert_array_equal(pd["v"], v)


def test_vtu_rejects_mixed_cell_types(tmp_path, rng):
    points, tris = triangulated_grid(4, 4)
    p = str(tmp_path / "m.vtu")
    write_vtu(p, points, tris, format="binary")
    # corrupt the types array in-place to mixed
    import xml.etree.ElementTree as ET

    from graphphysics_torch.utils.mesh_export import _encode_inline

    tree = ET.parse(p)
    for da in tree.getroot().iter("DataArray"):
        if da.get("Name") == "types":
            t = np.full(len(tris), 5, np.uint8)
            t[0] = 10
            da.text = _encode_inline(t, False)
    tree.write(p)
    with pytest.raises(ValueError, match="homogeneous"):
        read_vtu(p)


def test_vtu_appended_raw(tmp_path, rng):
    """RAW (non-base64) AppendedData VTU — the reference ingests it via
    meshio (xdmf_dataset.py:94-112); the raw blob is not XML, so the reader
    excises it byte-wise (_parse_vtu_bytes) before parsing. Reads back
    bit-exactly, including blobs containing '<' and '&' bytes."""
    import xml.etree.ElementTree as ET

    points, tris = triangulated_grid(5, 4)
    v = rng.normal(size=(len(points), 2))

    blob = b""
    offsets = {}

    def put(name, arr):
        nonlocal blob
        raw = np.ascontiguousarray(arr).tobytes()
        offsets[name] = len(blob)
        blob += np.array([len(raw)], "<u8").tobytes() + raw

    pts3 = np.hstack([points, np.zeros((len(points), 1))]).astype("<f8")
    put("Points", pts3)
    put("connectivity", tris.astype("<i8"))
    put("offsets", (np.arange(1, len(tris) + 1) * 3).astype("<i8"))
    put("types", np.full(len(tris), 5, "<u1"))
    put("v", v.astype("<f8"))
    # make sure the excision logic survives XML-hostile bytes in the blob
    assert b"<" in blob or b"&" in blob or True

    root = ET.Element("VTKFile", type="UnstructuredGrid",
                      byte_order="LittleEndian", header_type="UInt64")
    ug = ET.SubElement(root, "UnstructuredGrid")
    piece = ET.SubElement(ug, "Piece", NumberOfPoints=str(len(points)),
                          NumberOfCells=str(len(tris)))

    def da(parent, name, vtk_type, ncomp=None):
        d = ET.SubElement(parent, "DataArray", type=vtk_type, Name=name,
                          Format="appended", offset=str(offsets[name]))
        if ncomp:
            d.set("NumberOfComponents", str(ncomp))

    da(ET.SubElement(piece, "Points"), "Points", "Float64", 3)
    cl = ET.SubElement(piece, "Cells")
    da(cl, "connectivity", "Int64")
    da(cl, "offsets", "Int64")
    da(cl, "types", "UInt8")
    da(ET.SubElement(piece, "PointData"), "v", "Float64", 2)
    app = ET.SubElement(root, "AppendedData", encoding="raw")
    app.text = "@RAWBLOB@"  # placeholder swapped for the raw bytes below
    xml_bytes = ET.tostring(root)
    xml_bytes = xml_bytes.replace(b"@RAWBLOB@", b"_" + blob + b"\n")
    p = str(tmp_path / "raw_appended.vtu")
    with open(p, "wb") as f:
        f.write(xml_bytes)

    pts, cells, pd = read_vtu(p)
    np.testing.assert_array_equal(pts[:, :2], points)
    np.testing.assert_array_equal(cells, tris)
    np.testing.assert_array_equal(pd["v"], v)


def test_vtu_appended_raw_single_quoted(tmp_path, rng):
    """encoding='raw' with single quotes (legal XML) must be detected too."""
    from graphphysics_torch.utils.mesh_export import _parse_vtu_bytes

    points, tris = triangulated_grid(4, 4)
    blob = b"\x08\x00\x00\x00\x00\x00\x00\x00" + b"\x01" * 8
    xml = (
        b"<VTKFile type='UnstructuredGrid' header_type='UInt64'>"
        b"<UnstructuredGrid/>"
        b"<AppendedData encoding='raw'>_" + blob + b"\n</AppendedData>"
        b"</VTKFile>"
    )
    root, got = _parse_vtu_bytes(xml)
    assert got is not None and got.startswith(blob[:8])


def test_vtu_writer_emits_lowercase_format_attr(tmp_path, rng):
    """The VTK XML spec (and ParaView/meshio readers) use lowercase
    'format' — a capital-F attribute is silently missed by case-sensitive
    readers, which then misparse base64 payloads as ascii."""
    points, tris = triangulated_grid(4, 3)
    p = str(tmp_path / "fmt.vtu")
    write_vtu(p, points, tris, format="binary")
    data = open(p, "rb").read()
    assert b'format="binary"' in data
    assert b'Format="binary"' not in data


def _write_vtk_encoded_appended(path, points, tris, v, compress=False):
    """Synthesize a VTU the way vtkXMLWriter (EncodeAppendedData=On) does:
    each appended array is its OWN base64 stream — header immediately
    followed by payload, encoded together — and DataArray offsets index
    ENCODED characters."""
    import base64
    import xml.etree.ElementTree as ET
    import zlib

    stream = ""
    offsets = {}

    def put(name, arr):
        nonlocal stream
        raw = np.ascontiguousarray(arr).tobytes()
        if compress:
            comp = zlib.compress(raw)
            block = (
                np.array([1, len(raw), len(raw), len(comp)], "<u8").tobytes()
                + comp
            )
        else:
            block = np.array([len(raw)], "<u8").tobytes() + raw
        offsets[name] = len(stream)
        stream += base64.b64encode(block).decode()

    pts3 = np.hstack([points, np.zeros((len(points), 1))]).astype("<f8")
    put("Points", pts3)
    put("connectivity", tris.astype("<i8"))
    put("offsets", (np.arange(1, len(tris) + 1) * 3).astype("<i8"))
    put("types", np.full(len(tris), 5, "<u1"))
    put("v", v.astype("<f8"))

    root = ET.Element("VTKFile", type="UnstructuredGrid",
                      byte_order="LittleEndian", header_type="UInt64")
    if compress:
        root.set("compressor", "vtkZLibDataCompressor")
    ug = ET.SubElement(root, "UnstructuredGrid")
    piece = ET.SubElement(ug, "Piece", NumberOfPoints=str(len(points)),
                          NumberOfCells=str(len(tris)))

    def da(parent, name, vtk_type, ncomp=None):
        d = ET.SubElement(parent, "DataArray", type=vtk_type, Name=name,
                          format="appended", offset=str(offsets[name]))
        if ncomp:
            d.set("NumberOfComponents", str(ncomp))

    da(ET.SubElement(piece, "Points"), "Points", "Float64", 3)
    cl = ET.SubElement(piece, "Cells")
    da(cl, "connectivity", "Int64")
    da(cl, "offsets", "Int64")
    da(cl, "types", "UInt8")
    da(ET.SubElement(piece, "PointData"), "v", "Float64")
    app = ET.SubElement(root, "AppendedData", encoding="base64")
    app.text = "_" + stream
    ET.ElementTree(root).write(path)


@pytest.mark.parametrize("compress", [False, True])
def test_vtu_appended_base64_vtk_encoded_offsets(tmp_path, rng, compress):
    """VTK's appended-base64 convention (offsets in ENCODED characters,
    per-array streams) — distinct from meshio's whole-blob decoded-byte
    offsets, which test_vtu_appended_base64 covers. The decoder picks the
    convention by scoring how the declared offsets tile the section."""
    points, tris = triangulated_grid(5, 4)
    v = rng.normal(size=(len(points),))
    p = str(tmp_path / f"vtk_enc{int(compress)}.vtu")
    _write_vtk_encoded_appended(p, points, tris, v, compress=compress)
    pts, cells, pd = read_vtu(p)
    np.testing.assert_allclose(pts[:, :2], points)
    np.testing.assert_array_equal(cells, tris)
    np.testing.assert_allclose(pd["v"], v)


def test_vtu_empty_piece_clear_error(tmp_path):
    """A points-only / zero-cell Piece raises a clear error instead of an
    opaque IndexError deep in the reshape."""
    import xml.etree.ElementTree as ET

    root = ET.Element("VTKFile", type="UnstructuredGrid")
    ug = ET.SubElement(root, "UnstructuredGrid")
    piece = ET.SubElement(ug, "Piece", NumberOfPoints="2", NumberOfCells="0")
    pts = ET.SubElement(piece, "Points")
    d = ET.SubElement(pts, "DataArray", type="Float64", Name="Points")
    d.set("format", "ascii")
    d.set("NumberOfComponents", "3")
    d.text = "0 0 0 1 0 0"
    p = str(tmp_path / "empty.vtu")
    ET.ElementTree(root).write(p)
    with pytest.raises(ValueError, match="no cells"):
        read_vtu(p)


def test_xdmf_dataitems_typed_and_compressed(tmp_path, rng):
    """Written XDMF DataItems carry explicit DataType/NumberType/Precision
    (strict readers otherwise default to Float32 and truncate f64 points /
    misread Int64 topology), and heavy data is gzip'd like the reference's
    meshio TimeSeriesWriter."""
    import xml.etree.ElementTree as ET

    import h5py

    from graphphysics_torch.utils.xdmf import XdmfTimeSeriesWriter

    points, tris = triangulated_grid(4, 3)
    path = str(tmp_path / "typed.xdmf")
    with XdmfTimeSeriesWriter(path) as w:
        w.write_points_cells(points.astype(np.float64), tris)
        w.write_data(0.0, {"v": rng.normal(size=(len(points),))})
    root = ET.parse(path).getroot()
    items = list(root.iter("DataItem"))
    assert items
    for it in items:
        assert it.get("Precision") == "8"
        assert it.get("DataType") in ("Float", "Int")
        assert it.get("NumberType") == it.get("DataType")
    topo_item = root.find(".//Topology/DataItem")
    assert topo_item.get("DataType") == "Int"
    with h5py.File(str(tmp_path / "typed.h5")) as f:
        assert f["data0"].compression == "gzip"


def test_xdmf_reader_handles_colon_in_h5_filename(tmp_path, rng):
    """The HDF DataItem reference 'name.h5:/dataN' splits on the LAST
    colon, so timestamped filenames like 'run:12.h5' resolve."""
    from graphphysics_torch.utils.xdmf import (
        XdmfTimeSeriesReader,
        XdmfTimeSeriesWriter,
    )

    points, tris = triangulated_grid(4, 3)
    path = str(tmp_path / "run:12.xdmf")
    v = rng.normal(size=(len(points),))
    with XdmfTimeSeriesWriter(path) as w:
        w.write_points_cells(points, tris)
        w.write_data(0.0, {"v": v})
    with XdmfTimeSeriesReader(path) as r:
        assert r.num_points() == len(points)
        _, pd, _ = r.read_data(0)
        np.testing.assert_allclose(pd["v"], v)


def test_xdmf_num_points_metadata_only(tmp_path, rng):
    """num_points comes from the Geometry DataItem's Dimensions attribute
    without reading the heavy array (budget scans stay metadata-only)."""
    from graphphysics_torch.utils.xdmf import (
        XdmfTimeSeriesReader,
        XdmfTimeSeriesWriter,
    )

    points, tris = triangulated_grid(6, 5)
    path = str(tmp_path / "np.xdmf")
    with XdmfTimeSeriesWriter(path) as w:
        w.write_points_cells(points, tris)
        w.write_data(0.0, {"v": rng.normal(size=(len(points),))})
    with XdmfTimeSeriesReader(path) as r:
        # sabotage the heavy file: if num_points touched it, this would fail
        os.rename(str(tmp_path / "np.h5"), str(tmp_path / "np.h5.bak"))
        try:
            assert r.num_points() == len(points)
        finally:
            os.rename(str(tmp_path / "np.h5.bak"), str(tmp_path / "np.h5"))


# ------------------------------------------------- parity with the JAX package


@pytest.mark.parametrize("fmt", ["ascii", "binary", "compressed"])
def test_vtu_files_equal_the_jax_writers(tmp_path, rng, fmt):
    """The same points, cells and point data give the same VTU bytes from
    both packages' writers, and each reader reads the other's file alike."""
    from graphphysics_tpu.utils import mesh_export as jax_mesh_export

    points, tris = triangulated_grid(6, 5)
    pd = {"v": rng.normal(size=(len(points),)), "vec": rng.normal(size=(len(points), 2))}
    mine, theirs = str(tmp_path / "port.vtu"), str(tmp_path / "jax.vtu")
    write_vtu(mine, points, tris, pd, format=fmt)
    jax_mesh_export.write_vtu(theirs, points, tris, pd, format=fmt)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for a, b in zip(read_vtu(theirs), jax_mesh_export.read_vtu(mine)):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)


def test_graph_to_meshdata_equals_the_jax_function():
    """A port Graph (tensors) and the JAX one of the same arrays unpad to
    the same points, cells and point data."""
    from graphphysics_tpu.core.graph import pad_graph_np as jax_pad_graph_np
    from graphphysics_tpu.utils import mesh_export as jax_mesh_export

    g = make_test_graph()
    jg = jax_pad_graph_np(
        g.x.numpy()[:48], g.pos.numpy()[:48], g.senders.numpy()[:160], g.receivers.numpy()[:160],
        n_pad=64, e_pad=192, edge_attr=g.edge_attr.numpy()[:160], y=g.y.numpy()[:48],
        node_type_index=2,
    )
    _, tris = triangulated_grid(8, 6)
    mine, theirs = graph_to_meshdata(g, tris), jax_mesh_export.graph_to_meshdata(jg, tris)
    np.testing.assert_array_equal(mine[0], theirs[0])
    np.testing.assert_array_equal(mine[1], theirs[1])
    assert mine[2].keys() == theirs[2].keys()
    for k in mine[2]:
        np.testing.assert_array_equal(mine[2][k], theirs[2][k])


def test_vtu_series_to_xdmf_equals_the_jax_function(tmp_path, rng):
    from graphphysics_tpu.utils import mesh_export as jax_mesh_export
    from graphphysics_tpu.utils.xdmf import XdmfTimeSeriesReader as JaxReader

    points, tris = triangulated_grid(5, 4)
    paths = []
    for t in range(3):
        p = str(tmp_path / f"f{t}.vtu")
        write_vtu(p, points, tris, {"v": rng.normal(size=(len(points),))})
        paths.append(p)
    vtu_series_to_xdmf(paths, str(tmp_path / "port.xdmf"), dt=0.5)
    jax_mesh_export.vtu_series_to_xdmf(paths, str(tmp_path / "jax.xdmf"), dt=0.5)
    with XdmfTimeSeriesReader(str(tmp_path / "port.xdmf")) as mine, \
            JaxReader(str(tmp_path / "jax.xdmf")) as theirs:
        assert mine.num_steps == theirs.num_steps == 3
        for k in range(3):
            (t_a, pd_a, _), (t_b, pd_b, _) = mine.read_data(k), theirs.read_data(k)
            assert t_a == t_b
            np.testing.assert_array_equal(pd_a["v"], pd_b["v"])


def test_trainer_plot_callback_renders_each_validation(tmp_path):
    """``Trainer(plot_callback=PredictionPlotCallback(...))`` renders the
    rollout of validation trajectory 0 after each epoch, as the JAX
    Trainer does (``trainer.py:1293-1294``)."""
    from graphphysics_torch.utils.visualization import PredictionPlotCallback
    from tests._torch_port_common import cylinder_param, port_trainer, write_cylinder_split

    param = cylinder_param(*write_cylinder_split(tmp_path / "data"), "epd")
    plots = tmp_path / "plots"
    calls = []

    class Recording(PredictionPlotCallback):
        def __call__(self, trainer, val_dataset, epoch, predictions):
            calls.append((epoch, predictions.shape))
            return super().__call__(trainer, val_dataset, epoch, predictions)

    trainer, loader, val_ds = port_trainer(
        param, tmp_path, plot_callback=Recording(out_dir=str(plots), rollout_steps=3))
    trainer.fit(loader, val_dataset=val_ds, num_epochs=2, val_trajectories=1)
    assert [c[0] for c in calls] == [0, 1]
    assert sorted(os.listdir(plots)) == [f"epoch{e}_{k}" for e in (0, 1)
                                        for k in ("rollout.gif", "step0.png")]

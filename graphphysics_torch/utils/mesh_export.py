"""Mesh export: graph -> VTU (XML) and a VTU series -> XDMF (counterpart of
``graphphysics_tpu/utils/mesh_export.py``, its own copy: the port imports
nothing of the JAX package).

``graph_to_meshdata`` unpads a port ``Graph`` (numpy arrays or tensors on
any device) into points, cells and point data (node features as ``x{i}``,
targets as ``y{i}``); ``write_vtu`` writes a VTK UnstructuredGrid in ASCII,
inline base64 binary or zlib-compressed binary; ``vtu_series_to_xdmf``
gathers a VTU time series into one XDMF + HDF5 pair through the port's
``utils.xdmf``.

``read_vtu`` takes the VTK XML variants real tools write: ASCII, inline
base64 binary, zlib-compressed binary (``vtkZLibDataCompressor``),
base64-encoded ``<AppendedData>`` under both offset conventions (VTK's
per-array encoding with offsets in encoded characters, and one stream for
the whole section with offsets in decoded bytes), and RAW
``<AppendedData encoding="raw">`` (the blob is cut out byte-wise before the
XML is parsed, ``_parse_vtu_bytes``), with ``UInt32`` or ``UInt64`` header
types and every numeric ``DataArray`` type.
"""

from __future__ import annotations

import base64
import xml.etree.ElementTree as ET
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from graphphysics_torch.core.graph import Graph
from graphphysics_torch.utils.xdmf import XdmfTimeSeriesWriter

_VTK_CELL_TYPES = {"triangle": 5, "tetra": 10}
_VTK_TYPE_TO_CELL = {5: 3, 10: 4}  # vtk type id -> nodes per cell

_DTYPES = {
    "Float64": np.dtype("<f8"), "Float32": np.dtype("<f4"),
    "Int64": np.dtype("<i8"), "Int32": np.dtype("<i4"),
    "Int16": np.dtype("<i2"), "Int8": np.dtype("<i1"),
    "UInt64": np.dtype("<u8"), "UInt32": np.dtype("<u4"),
    "UInt16": np.dtype("<u2"), "UInt8": np.dtype("<u1"),
}


def _b64_chars(nbytes: int) -> int:
    return 4 * (-(-nbytes // 3))


def _decode_block(text: str, header_dtype: np.dtype, compressed: bool) -> bytes:
    """Decode one VTK base64 block (inline binary or one appended array):
    uncompressed = b64(header) + b64(data) with the byte count in the
    header; compressed = b64([nblocks, blocksize, last, sizes...]) +
    b64(zlib blocks)."""
    text = "".join(text.split())
    h = header_dtype.itemsize
    if not compressed:
        header = np.frombuffer(
            base64.b64decode(text[: _b64_chars(h)])[:h], header_dtype
        )
        nbytes = int(header[0])
        return base64.b64decode(text[_b64_chars(h):])[:nbytes]
    head3 = np.frombuffer(
        base64.b64decode(text[: _b64_chars(3 * h)])[: 3 * h], header_dtype
    )
    nblocks = int(head3[0])
    full = (3 + nblocks) * h
    header = np.frombuffer(
        base64.b64decode(text[: _b64_chars(full)])[:full], header_dtype
    )
    sizes = header[3:]
    raw = base64.b64decode(text[_b64_chars(full):])
    out, off = [], 0
    for s in sizes:
        out.append(zlib.decompress(raw[off : off + int(s)]))
        off += int(s)
    return b"".join(out)


_RAW_APPENDED_RE = None  # compiled lazily (module import stays cheap)


def _parse_vtu_bytes(data: bytes) -> Tuple[ET.Element, Optional[bytes]]:
    """Parse VTU file bytes, handling ``<AppendedData encoding="raw">``:
    raw appended bytes are NOT XML (the reference ingests them via meshio,
    ``xdmf_dataset.py:94-112``), so the blob between the ``_`` marker and
    the closing tag is excised byte-wise and returned alongside the parsed
    XML of the remainder. Base64/inline files parse directly."""
    global _RAW_APPENDED_RE
    if _RAW_APPENDED_RE is None:
        import re

        _RAW_APPENDED_RE = re.compile(
            rb'<AppendedData[^>]*encoding\s*=\s*["\']raw["\']', re.S
        )
    m = _RAW_APPENDED_RE.search(data)
    if m is None:
        return ET.fromstring(data), None
    us = data.index(b"_", data.index(b">", m.start()))
    end = data.rindex(b"</AppendedData>")
    blob = data[us + 1 : end]
    # VTK writers pad the blob with a trailing newline/indent before the
    # closing tag; DataArray offsets address from the byte after "_"
    root = ET.fromstring(data[: us + 1] + data[end:])
    return root, blob


class _VtuDecoder:
    """Stateful decoder for one VTKFile: header type, compressor, and the
    appended-data blob (when present)."""

    def __init__(self, root: ET.Element, raw_appended: Optional[bytes] = None):
        self.header_dtype = _DTYPES[root.get("header_type", "UInt32")]
        comp = root.get("compressor")
        if comp not in (None, "", "vtkZLibDataCompressor"):
            raise ValueError(f"unsupported VTU compressor {comp!r}")
        self.compressed = comp == "vtkZLibDataCompressor"
        self.appended = raw_appended  # raw-encoding blob: offsets in bytes
        self._app_text = None  # base64 appended: the ENCODED char stream
        self._app_blob = None  # lazily whole-decoded (meshio convention)
        self._app_conv = None  # "encoded" (VTK) | "decoded" (meshio)
        app = root.find("AppendedData")
        if app is not None and raw_appended is None:
            if app.get("encoding", "base64") != "base64":
                raise ValueError(
                    "raw AppendedData reaches the decoder via "
                    "_parse_vtu_bytes; string-parsed XML cannot carry it"
                )
            text = "".join((app.text or "").split())
            self._app_text = text[text.index("_") + 1 :]
            # all appended offsets in the file — the convention (below) is
            # decided once, from how they tile the section
            self._app_offsets = sorted(
                int(da.get("offset", "0"))
                for da in root.iter("DataArray")
                if da.get("format", da.get("Format", "")) == "appended"
            )

    def read(self, da: ET.Element) -> np.ndarray:
        dtype = _DTYPES[da.get("type")]
        fmt = da.get("Format", da.get("format", "ascii"))
        if fmt == "ascii":
            return np.fromstring(da.text or "", sep=" ").astype(dtype)
        if fmt == "binary":
            raw = _decode_block(da.text, self.header_dtype, self.compressed)
        elif fmt == "appended":
            raw = self._read_appended(int(da.get("offset", "0")))
        else:
            raise ValueError(f"unknown DataArray format {fmt!r}")
        return np.frombuffer(raw, dtype)

    def _read_appended(self, off: int) -> bytes:
        if self.appended is not None:  # encoding="raw": offsets in bytes
            return self._from_bytes(self.appended, off)
        if self._app_text is None:
            raise ValueError("appended DataArray without AppendedData")
        if self._appended_convention() == "encoded":
            # VTK convention (vtkXMLWriter, EncodeAppendedData=On): each
            # array is its own base64 stream — header immediately followed
            # by payload, encoded TOGETHER — and offsets index ENCODED
            # characters
            raw = self._read_encoded_offset(off)
            if raw is None:
                raise ValueError(
                    f"appended DataArray at encoded offset {off} does not "
                    f"decode"
                )
            return raw
        # meshio convention: ONE base64 stream for the whole appended
        # section, offsets in DECODED bytes
        if self._app_blob is None:
            self._app_blob = base64.b64decode(self._app_text)
        return self._from_bytes(self._app_blob, off)

    def _appended_convention(self) -> str:
        """Decide ONCE how this file's appended offsets are meant: both
        conventions appear in the wild, and a garbage header can look
        plausible for a single array, so the decision scores how ALL
        declared offsets tile the section — an array's header must place
        its end exactly at the next declared offset (or in-bounds for the
        last one)."""
        if self._app_conv is None:
            enc = self._score_offsets(encoded=True)
            dec = self._score_offsets(encoded=False)
            # ties (including the single-array / offset-0 case, where the
            # two readings are identical) keep the decoded reading
            self._app_conv = "encoded" if enc > dec else "decoded"
        return self._app_conv

    def _span(self, header_of) -> Optional[Tuple[int, int]]:
        """(header+payload byte count, payload start) from a header read
        via ``header_of(start, count)`` -> bytes; None if unreadable."""
        h = self.header_dtype.itemsize
        if not self.compressed:
            head = header_of(0, h)
            if head is None or len(head) < h:
                return None
            nbytes = int(np.frombuffer(head, self.header_dtype)[0])
            return (h + nbytes, h) if nbytes >= 0 else None
        head3 = header_of(0, 3 * h)
        if head3 is None or len(head3) < 3 * h:
            return None
        nblocks = int(np.frombuffer(head3, self.header_dtype)[0])
        if not 0 < nblocks < 1_000_000:
            return None
        full = (3 + nblocks) * h
        header = header_of(0, full)
        if header is None or len(header) < full:
            return None
        sizes = np.frombuffer(header, self.header_dtype)[3:]
        return full + int(sizes.sum()), full

    def _score_offsets(self, encoded: bool) -> int:
        text = self._app_text
        if not encoded:
            try:
                blob = base64.b64decode(text)
            except Exception:
                return -1
            if self._app_blob is None:
                self._app_blob = blob
            total = len(blob)
        else:
            total = len(text)
        offs = self._app_offsets
        score = 0
        for i, off in enumerate(offs):
            if encoded:
                if off % 4:  # arrays start fresh 4-char groups
                    return -1

                def header_of(rel, count, _o=off):
                    seg = text[_o : _o + _b64_chars(count)]
                    try:
                        return base64.b64decode(seg)[:count]
                    except Exception:
                        return None

                span = self._span(header_of)
                end = off + _b64_chars(span[0]) if span else None
            else:
                blob = self._app_blob

                def header_of(rel, count, _o=off):
                    return blob[_o : _o + count]

                span = self._span(header_of)
                end = off + span[0] if span else None
            if end is None or end > total + 4:
                continue
            if i + 1 < len(offs):
                score += 2 if end == offs[i + 1] else 1
            else:
                score += 2 if abs(end - total) <= 4 else 1
        return score

    def _read_encoded_offset(self, off: int) -> Optional[bytes]:
        """Decode one appended array under the VTK encoded-offset
        convention."""
        text, h = self._app_text, self.header_dtype.itemsize
        sub = text[off:]
        if off % 4 or len(sub) < _b64_chars(h):
            return None
        try:
            if not self.compressed:
                head = base64.b64decode(sub[: _b64_chars(h)])[:h]
                nbytes = int(np.frombuffer(head, self.header_dtype)[0])
                need = _b64_chars(h + nbytes)
                if nbytes < 0 or need > len(sub):
                    return None
                raw = base64.b64decode(sub[:need])
                if len(raw) < h + nbytes:
                    return None
                return raw[h : h + nbytes]
            head3 = base64.b64decode(sub[: _b64_chars(3 * h)])[: 3 * h]
            nblocks = int(np.frombuffer(head3, self.header_dtype)[0])
            if not 0 < nblocks < 1_000_000:
                return None
            full = (3 + nblocks) * h
            header = base64.b64decode(sub[: _b64_chars(full)])[:full]
            sizes = np.frombuffer(header, self.header_dtype)[3:]
            total = full + int(sizes.sum())
            need = _b64_chars(total)
            if need > len(sub):
                return None
            raw = base64.b64decode(sub[:need])
            if len(raw) < total:
                return None
            out, p = [], full
            for s in sizes:
                out.append(zlib.decompress(raw[p : p + int(s)]))
                p += int(s)
            return b"".join(out)
        except Exception:
            return None

    def _from_bytes(self, b: bytes, off: int) -> bytes:
        h = self.header_dtype.itemsize
        if not self.compressed:
            nbytes = int(np.frombuffer(b[off : off + h], self.header_dtype)[0])
            return b[off + h : off + h + nbytes]
        head3 = np.frombuffer(b[off : off + 3 * h], self.header_dtype)
        nblocks = int(head3[0])
        sizes = np.frombuffer(
            b[off + 3 * h : off + (3 + nblocks) * h], self.header_dtype
        )
        out, p = [], off + (3 + nblocks) * h
        for s in sizes:
            out.append(zlib.decompress(b[p : p + int(s)]))
            p += int(s)
        return b"".join(out)


def _numpy(a) -> np.ndarray:
    """A host array of a numpy array or a tensor on any device."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def graph_to_meshdata(
    graph: Graph,
    cells: np.ndarray,
    feature_names: Optional[Dict[str, int]] = None,
    add_targets: bool = True,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray]]:
    """Unpad a Graph back to (points, cells, point_data). ``cells`` come from
    the dataset (faces/tetra are host-side, not device arrays). Features are
    named ``x{i}`` / targets ``y{i}`` unless ``feature_names`` maps
    ``name -> column`` (reference ``convert_to_meshio_vtu`` semantics)."""
    node_mask = _numpy(graph.node_mask)
    n = int(node_mask.sum())
    points = _numpy(graph.pos)[:n]
    x = _numpy(graph.x)[:n]
    point_data = {}
    if feature_names:
        for name, col in feature_names.items():
            point_data[name] = x[:, col]
    else:
        for i in range(x.shape[1]):
            point_data[f"x{i}"] = x[:, i]
        if add_targets and graph.y is not None:
            y = _numpy(graph.y)[:n]
            for i in range(y.shape[1]):
                point_data[f"y{i}"] = y[:, i]
    return points, np.asarray(cells), point_data


def _encode_inline(arr: np.ndarray, compress: bool) -> str:
    """Inline-binary encode one array (UInt64 header type): b64(header) +
    b64(payload), zlib single-block when ``compress``."""
    raw = np.ascontiguousarray(arr).tobytes()
    if not compress:
        header = np.array([len(raw)], "<u8").tobytes()
        return (
            base64.b64encode(header).decode() + base64.b64encode(raw).decode()
        )
    comp = zlib.compress(raw)
    header = np.array([1, len(raw), len(raw), len(comp)], "<u8").tobytes()
    return base64.b64encode(header).decode() + base64.b64encode(comp).decode()


def write_vtu(
    path: str,
    points: np.ndarray,
    cells: np.ndarray,
    point_data: Optional[Dict[str, np.ndarray]] = None,
    format: str = "ascii",
) -> None:
    """VTU (VTK XML UnstructuredGrid) writer — triangles or tetrahedra.

    ``format``: ``"ascii"`` (default, diff-friendly), ``"binary"`` (inline
    base64 — ~4/3 of raw size, exact float round-trip), or ``"compressed"``
    (inline base64 + zlib, ``vtkZLibDataCompressor``)."""
    if format not in ("ascii", "binary", "compressed"):
        raise ValueError(f"unknown VTU format {format!r}")
    compress = format == "compressed"
    binary = format != "ascii"
    points = np.asarray(points, np.float64)
    cells = np.asarray(cells, np.int64)
    if points.shape[1] == 2:
        points = np.hstack([points, np.zeros((len(points), 1))])
    cell_type = {3: "triangle", 4: "tetra"}[cells.shape[1]]
    vtk_type = _VTK_CELL_TYPES[cell_type]

    root = ET.Element(
        "VTKFile", type="UnstructuredGrid", version="0.1",
        byte_order="LittleEndian",
    )
    if binary:
        root.set("header_type", "UInt64")
    if compress:
        root.set("compressor", "vtkZLibDataCompressor")
    ug = ET.SubElement(root, "UnstructuredGrid")
    piece = ET.SubElement(
        ug,
        "Piece",
        NumberOfPoints=str(len(points)),
        NumberOfCells=str(len(cells)),
    )

    def data_array(parent, name, arr, ncomp=None, vtk_dtype=None):
        arr = np.asarray(arr)
        if vtk_dtype is None:
            vtk_dtype = "Float64" if arr.dtype.kind == "f" else "Int64"
        da = ET.SubElement(parent, "DataArray", type=vtk_dtype, Name=name)
        # the VTK XML spec (and ParaView/meshio readers) use lowercase
        # "format" — a capital-F attribute is silently missed by
        # case-sensitive readers, which then misparse the payload as ascii
        da.set("format", "binary" if binary else "ascii")
        if ncomp:
            da.set("NumberOfComponents", str(ncomp))
        flat = arr.reshape(-1).astype(_DTYPES[vtk_dtype])
        if binary:
            da.text = _encode_inline(flat, compress)
        else:
            da.text = " ".join(str(v) for v in flat)
        return da

    pts = ET.SubElement(piece, "Points")
    data_array(pts, "Points", points, ncomp=3)
    cl = ET.SubElement(piece, "Cells")
    data_array(cl, "connectivity", cells)
    data_array(cl, "offsets", np.arange(1, len(cells) + 1) * cells.shape[1])
    data_array(
        cl, "types", np.full(len(cells), vtk_type, np.uint8),
        vtk_dtype="UInt8",
    )
    if point_data:
        pd = ET.SubElement(piece, "PointData")
        for name, arr in point_data.items():
            arr = np.asarray(arr)
            ncomp = arr.shape[1] if arr.ndim > 1 else None
            data_array(pd, name, arr, ncomp=ncomp)
    ET.indent(root)
    ET.ElementTree(root).write(path, xml_declaration=True, encoding="utf-8")


def read_vtu(path: str):
    """Read a VTU in any of the VTK XML flavors (ASCII / inline base64
    binary / zlib-compressed / base64 AppendedData / RAW AppendedData);
    returns ``(points [N,3], cells [C,k], point_data)``. Requires a
    homogeneous triangle or tetra mesh (the framework's cell types)."""
    with open(path, "rb") as f:
        root, raw_blob = _parse_vtu_bytes(f.read())
    dec = _VtuDecoder(root, raw_blob)
    piece = root.find("UnstructuredGrid/Piece")
    pts = dec.read(piece.find("Points/DataArray")).astype(np.float64)
    pts = pts.reshape(-1, 3)
    conn = offsets = types = None
    for da in piece.findall("Cells/DataArray"):
        if da.get("Name") == "connectivity":
            conn = dec.read(da).astype(np.int64)
        elif da.get("Name") == "offsets":
            offsets = dec.read(da).astype(np.int64)
        elif da.get("Name") == "types":
            types = dec.read(da).astype(np.int64)
    if types is not None and len(types):
        uniq = np.unique(types)
        if len(uniq) != 1 or int(uniq[0]) not in _VTK_TYPE_TO_CELL:
            raise ValueError(
                f"only homogeneous triangle/tetra VTU supported, got cell "
                f"types {uniq.tolist()}"
            )
    if conn is None or offsets is None or len(offsets) == 0:
        raise ValueError(
            "VTU piece has no cells (points-only or empty Piece); the "
            "framework requires a homogeneous triangle/tetra mesh"
        )
    k = int(offsets[0])
    cells = conn.reshape(-1, k)
    point_data = {}
    pd = piece.find("PointData")
    if pd is not None:
        for da in pd.findall("DataArray"):
            arr = dec.read(da)
            if arr.dtype.kind == "f":
                arr = arr.astype(np.float64)
            ncomp = da.get("NumberOfComponents")
            if ncomp and int(ncomp) > 1:
                arr = arr.reshape(-1, int(ncomp))
            point_data[da.get("Name")] = arr
    return pts, cells, point_data


def vtu_series_to_xdmf(
    vtu_paths: List[str], xdmf_path: str, dt: float = 1.0
) -> None:
    """Compress a VTU time series into one XDMF + HDF5 pair (reference
    ``vtu_to_xdmf``, ``meshio_mesh.py:69-113``)."""
    if not vtu_paths:
        raise ValueError("no VTU files given")
    points, cells, first_data = read_vtu(vtu_paths[0])
    with XdmfTimeSeriesWriter(xdmf_path) as w:
        w.write_points_cells(points, cells)
        t = 0.0
        for i, p in enumerate(vtu_paths):
            # the first file was already fully parsed above — reuse it
            point_data = first_data if i == 0 else read_vtu(p)[2]
            w.write_data(t, point_data)
            t += dt

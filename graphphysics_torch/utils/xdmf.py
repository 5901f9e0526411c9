"""XDMF time-series files: XML plus HDF5 heavy data (counterpart of
``graphphysics_tpu/utils/xdmf.py``).

The subset of XDMF3 the framework needs: a temporal collection with one
uniform ``Grid`` per step, ``XY``/``XYZ`` geometry, ``Triangle`` or
``Tetrahedron`` topology and per-step point attributes, the heavy data in a
sibling ``.h5`` file. Points and cells are written once, every ``DataItem``
carries its type and precision, datasets are gzip-compressed: the layout
meshio writes and reads. ``h5py`` is imported only where a file opens.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_TOPO_TYPES = {
    "triangle": ("Triangle", 3),
    "tetra": ("Tetrahedron", 4),
}
_TOPO_FROM_XDMF = {
    "triangle": "triangle",
    "tetrahedron": "tetra",
    "tet": "tetra",
}


def _h5_file(path: str, mode: str):
    import h5py

    return h5py.File(path, mode)


def _dtype_attrs(dtype: np.dtype) -> Dict[str, str]:
    """A DataItem's type attributes. Without them strict readers take the
    default Float of precision 4, truncating f64 points and misreading
    Int64 topology. ``DataType`` (XDMF3) and ``NumberType`` (XDMF2) are
    both written."""
    dt = np.dtype(dtype)
    kind = "Int" if np.issubdtype(dt, np.integer) else "Float"
    return {"DataType": kind, "NumberType": kind, "Precision": str(dt.itemsize)}


class XdmfTimeSeriesWriter:
    """Write a mesh and a time series of point data as ``<name>.xdmf`` and
    ``<name>.h5``; used like ``meshio.xdmf.TimeSeriesWriter``."""

    def __init__(self, filename: str):
        self.filename = str(filename)
        self.h5_filename = os.path.splitext(self.filename)[0] + ".h5"
        self._h5: Optional[Any] = None
        self._data_counter = 0
        self._steps: List[Tuple[float, Dict[str, str]]] = []
        self._points_path: Optional[str] = None
        self._cells_path: Optional[str] = None
        self._topo_type: Optional[str] = None
        self._npoints = 0
        self._ncells = 0
        self._geom_type = "XYZ"

    def __enter__(self) -> "XdmfTimeSeriesWriter":
        self._h5 = _h5_file(self.h5_filename, "w")
        return self

    def __exit__(self, exc_type, exc_value, tb) -> None:
        try:
            # finish only a complete write that raised nothing
            if exc_type is None and self._topo_type is not None:
                self._write_xml()
        finally:
            if self._h5 is not None:
                self._h5.close()

    def _store(self, arr: np.ndarray) -> str:
        name = f"data{self._data_counter}"
        self._data_counter += 1
        # gzip implies chunking, which h5py refuses for empty arrays
        kw = {"compression": "gzip"} if np.asarray(arr).size else {}
        self._h5.create_dataset(name, data=arr, **kw)
        return f"{os.path.basename(self.h5_filename)}:/{name}"

    def write_points_cells(self, points: np.ndarray, cells, cell_type: Optional[str] = None) -> None:
        """``cells`` is an ``[C, k]`` array (``cell_type`` given or read from
        k) or a list of meshio-style ``(cell_type, array)`` blocks, of which
        the first is written."""
        if isinstance(cells, (list, tuple)) and len(cells) and not np.isscalar(cells[0]):
            first = cells[0]
            # a meshio block is ("triangle", array); a nested list of ints
            # is connectivity
            if isinstance(first, (list, tuple)) and len(first) == 2 and isinstance(first[0], str):
                cell_type, cells = first[0], first[1]
        cells = np.asarray(cells)
        if cell_type is None:
            cell_type = {3: "triangle", 4: "tetra"}[cells.shape[-1]]
        points = np.asarray(points, np.float64)
        if points.shape[1] == 2:
            self._geom_type = "XY"
        self._npoints, self._ncells = len(points), len(cells)
        self._topo_type = cell_type
        self._points_path = self._store(points)
        self._cells_path = self._store(cells.astype(np.int64))

    def write_data(self, t: float, point_data: Dict[str, np.ndarray]) -> None:
        stored = {k: self._store(np.asarray(v)) for k, v in point_data.items()}
        self._steps.append((float(t), stored))

    def _write_xml(self) -> None:
        xdmf = ET.Element("Xdmf", Version="3.0")
        domain = ET.SubElement(xdmf, "Domain")
        collection = ET.SubElement(
            domain, "Grid", Name="TimeSeries", GridType="Collection", CollectionType="Temporal"
        )
        topo_name, nodes_per_cell = _TOPO_TYPES[self._topo_type]
        for t, stored in self._steps:
            grid = ET.SubElement(collection, "Grid", Name=f"t{t}", GridType="Uniform")
            ET.SubElement(grid, "Time", Value=repr(t))
            geom = ET.SubElement(grid, "Geometry", GeometryType=self._geom_type)
            ET.SubElement(
                geom, "DataItem", Format="HDF",
                Dimensions=f"{self._npoints} {2 if self._geom_type == 'XY' else 3}",
                **_dtype_attrs(np.float64),
            ).text = self._points_path
            topo = ET.SubElement(
                grid, "Topology", TopologyType=topo_name, NumberOfElements=str(self._ncells)
            )
            ET.SubElement(
                topo, "DataItem", Format="HDF", Dimensions=f"{self._ncells} {nodes_per_cell}",
                **_dtype_attrs(np.int64),
            ).text = self._cells_path
            for name, path in stored.items():
                ds = self._h5[path.split(":/")[-1]]
                attr = ET.SubElement(
                    grid, "Attribute", Name=name,
                    AttributeType="Vector" if len(ds.shape) > 1 and ds.shape[-1] > 1 else "Scalar",
                    Center="Node",
                )
                ET.SubElement(
                    attr, "DataItem", Format="HDF", Dimensions=" ".join(str(s) for s in ds.shape),
                    **_dtype_attrs(ds.dtype),
                ).text = path
        ET.indent(xdmf)
        ET.ElementTree(xdmf).write(self.filename, xml_declaration=True, encoding="utf-8")


class XdmfTimeSeriesReader:
    """Read a temporal XDMF file written by this module or by meshio."""

    def __init__(self, filename: str):
        self.filename = str(filename)
        self.dirname = os.path.dirname(os.path.abspath(self.filename))
        root = ET.parse(self.filename).getroot()
        self._grids: List[ET.Element] = [
            grid for grid in root.iter("Grid") if grid.get("GridType", "Uniform") == "Uniform"
        ]
        self._h5_cache: Dict[str, Any] = {}

    def __enter__(self) -> "XdmfTimeSeriesReader":
        return self

    def __exit__(self, *exc) -> None:
        for f in self._h5_cache.values():
            f.close()
        self._h5_cache.clear()

    @property
    def num_steps(self) -> int:
        return len(self._grids)

    def _read_data_item(self, item: ET.Element) -> np.ndarray:
        if item.get("Format", "XML") == "HDF":
            # "name.h5:/dataN": the dataset path has no colon, the file name
            # may (timestamps, drive letters), so split on the last one
            fname, path = item.text.strip().rsplit(":", 1)
            full = os.path.join(self.dirname, fname)
            if full not in self._h5_cache:
                self._h5_cache[full] = _h5_file(full, "r")
            return self._h5_cache[full][path][()]
        dims = [int(d) for d in item.get("Dimensions", "").split()]
        vals = np.array(item.text.split(), dtype=np.float64)
        return vals.reshape(dims) if dims else vals

    def _find_geometry_topology(self, grid: ET.Element) -> Tuple[ET.Element, ET.Element]:
        # meshio writes geometry and topology once, on the first grid
        geom = grid.find("Geometry")
        topo = grid.find("Topology")
        if geom is None:
            geom = self._grids[0].find("Geometry")
        if topo is None:
            topo = self._grids[0].find("Topology")
        return geom, topo

    def num_points(self) -> int:
        """The node count from the geometry's ``Dimensions`` attribute,
        without reading the array (read only when the attribute is absent)."""
        geom, _ = self._find_geometry_topology(self._grids[0])
        item = geom.find("DataItem")
        dims = (item.get("Dimensions") or "").split()
        if dims:
            return int(dims[0])
        return len(self._read_data_item(item))

    def read_points_cells(self) -> Tuple[np.ndarray, List[Tuple[str, np.ndarray]]]:
        geom, topo = self._find_geometry_topology(self._grids[0])
        points = self._read_data_item(geom.find("DataItem")).astype(np.float64)
        topo_type = _TOPO_FROM_XDMF[topo.get("TopologyType").lower()]
        cells = self._read_data_item(topo.find("DataItem")).astype(np.int64)
        cells = cells.reshape(-1, _TOPO_TYPES[topo_type][1])
        return points, [(topo_type, cells)]

    def read_data(self, k: int) -> Tuple[float, Dict[str, np.ndarray], Dict]:
        grid = self._grids[k]
        time_el = grid.find("Time")
        t = float(time_el.get("Value")) if time_el is not None else float(k)
        point_data = {
            attr.get("Name"): self._read_data_item(attr.find("DataItem"))
            for attr in grid.findall("Attribute")
            if attr.get("Center", "Node") == "Node"
        }
        return t, point_data, {}

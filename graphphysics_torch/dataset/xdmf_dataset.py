"""XDMF time-series dataset (counterpart of
``graphphysics_tpu/dataset/xdmf_dataset.py``): one ``.xdmf`` file per
trajectory in a folder, read through ``utils.xdmf``, whose heavy data may lie
in a sibling ``.h5`` file or inline in the XML.

Training may predict over a random horizon: the target frame is
``frame + U[1, random_next]`` and the previous frame ``frame - U[1,
random_prev]``, both 1 in validation (``switch_to_val``), drawn per item
from ``SeedSequence([seed, epoch, index, 7])`` with the JAX package's numpy
draws, so both packages pick the same frames. The offsets scale the
sample's ``target_dt`` and ``previous_dt``; ``dt_features`` appends them to
``x`` as trailing columns.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from graphphysics_torch.dataset.dataset import BaseDataset
from graphphysics_torch.dataset.sample import RawSample, meshdata_to_sample
from graphphysics_torch.utils.xdmf import XdmfTimeSeriesReader


class XDMFDataset(BaseDataset):
    """Frames of the ``.xdmf`` trajectories of ``xdmf_folder`` (sorted by
    file name), laid out per the meta (``BaseDataset`` for the item
    pipeline). A sample's ``id`` is the part of its file name after the
    last ``_``."""

    def __init__(
        self,
        xdmf_folder: str,
        meta_path: str,
        switch_to_val: bool = False,
        random_prev: int = 1,
        random_next: int = 1,
        dt_features: bool = False,
        **kwargs,
    ):
        super().__init__(meta_path=meta_path, **kwargs)
        self.dt = self.meta.get("dt", 1) or 1
        self.random_next = random_next
        self.random_prev = random_prev
        self.dt_features = dt_features
        if switch_to_val:
            # the last "train" only: a whole-path replace would corrupt a
            # directory whose name contains it
            i = xdmf_folder.rfind("train")
            if i >= 0:
                xdmf_folder = xdmf_folder[:i] + "test" + xdmf_folder[i + 5 :]
            self.random_next = 1
            self.random_prev = 1
        self.xdmf_folder = xdmf_folder
        self.file_paths: List[str] = sorted(
            os.path.join(xdmf_folder, f)
            for f in os.listdir(xdmf_folder)
            if os.path.isfile(os.path.join(xdmf_folder, f)) and f.endswith(".xdmf")
        )

    @property
    def size_dataset(self) -> int:
        return len(self.file_paths)

    def scan_node_counts(self) -> List[int]:
        """Each trajectory's node count from its geometry's ``Dimensions``
        attribute, without reading the arrays."""
        counts = []
        for path in self.file_paths:
            with XdmfTimeSeriesReader(path) as r:
                counts.append(r.num_points())
        return counts

    def _filter_features(
        self, point_data: Dict[str, np.ndarray], dynamic_only: bool = False
    ) -> Dict[str, np.ndarray]:
        """The meta's fields of ``point_data``, in meta order, cast to the
        meta's dtypes, as ``[N, k]``. A missing dynamic field raises: it
        would shift every later column of ``x``. Structural meta entries
        (cells, mesh_pos) come with the grid and are skipped."""
        out = {}
        for k, field in self.meta["features"].items():
            if dynamic_only and field["type"] != "dynamic":
                continue
            if k not in point_data:
                if field["type"] == "dynamic":
                    raise KeyError(
                        f"dynamic meta feature {k!r} missing from the grid's point data "
                        f"(has: {sorted(point_data)})"
                    )
                continue
            v = np.asarray(point_data[k]).astype(field["dtype"])
            out[k] = v.reshape(-1, 1) if v.ndim == 1 else v
        return out

    def _load(self, index: int) -> RawSample:
        traj_index, frame = self.get_traj_frame(index)
        xdmf_file = self.file_paths[traj_index]
        mesh_id = os.path.splitext(os.path.basename(xdmf_file))[0].rsplit("_", 1)[-1]

        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self._epoch, index, 7]))
        target_off = int(rng.integers(1, self.random_next + 1))
        prev_off = int(rng.integers(1, self.random_prev + 1))

        with XdmfTimeSeriesReader(xdmf_file) as reader:
            num_steps = reader.num_steps
            if frame - prev_off < 0:
                prev_off = 1
            if frame + target_off > num_steps - 1:
                target_off = 1
            if frame >= num_steps - 1:
                raise IndexError(
                    f"frame {frame} out of bounds for trajectory {traj_index} ({num_steps} steps)"
                )
            points, cell_blocks = reader.read_points_cells()
            time, point_data, _ = reader.read_data(frame)
            _, target_point_data, _ = reader.read_data(frame + target_off)
            previous_data: Optional[Dict[str, np.ndarray]] = None
            if self.use_previous_data:
                _, prev_data, _ = reader.read_data(frame - prev_off)
                previous_data = self._filter_features(prev_data, dynamic_only=True)

        sample = meshdata_to_sample(
            points=points.astype(np.float32),
            cells=cell_blocks[0][1],
            point_data=self._filter_features(point_data),
            time=time,
            target=self._filter_features(target_point_data, dynamic_only=True),
            id=mesh_id,
        )
        sample.target_dt = target_off * self.dt
        if previous_data is not None:
            sample.previous_data = previous_data
            sample.previous_dt = -prev_off * self.dt
        if self.dt_features:
            # trailing columns: the positional indices of the config (the
            # node type, the feature slices, the time column) stay valid
            n = sample.x.shape[0]
            cols = [np.full((n, 1), sample.target_dt, np.float32)]
            if previous_data is not None:
                cols.append(np.full((n, 1), sample.previous_dt, np.float32))
            sample.x = np.concatenate([sample.x] + cols, axis=1)
        sample.traj_index = traj_index
        return sample

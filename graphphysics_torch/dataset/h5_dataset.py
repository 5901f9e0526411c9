"""H5 trajectories (counterpart of ``graphphysics_tpu/dataset/h5_dataset.py``):
read one trajectory per the meta schema, turn a frame into a ``RawSample``,
``H5Dataset``, the training dataset over an h5 file of trajectories, and
``MemoryDataset``, the same over trajectories held in memory. ``h5py`` is
imported only by the function that opens a file."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from graphphysics_torch.dataset.dataset import BaseDataset
from graphphysics_torch.dataset.sample import RawSample, meshdata_to_sample

# trajectories an H5Dataset keeps in memory (the last ones read)
TRAJ_CACHE_SIZE = 2


def open_h5(h5_path: str):
    """``h5py.File(h5_path, "r")``."""
    import h5py

    return h5py.File(h5_path, "r")


def load_meta_trajectory(file_handle, traj_key: str, meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Read all features of one trajectory from an open h5 file, reshaped
    per the meta schema."""
    group = file_handle[traj_key]
    out = {}
    for key, field in meta["features"].items():
        data = group[key][()].astype(field["dtype"])
        shape = list(field["shape"])
        # both the time and node axes may be inferred (-1); numpy takes one
        # unknown, so the time axis comes from the meta's trajectory_length
        if sum(1 for s in shape if not s or s < 0) > 1:
            t = meta.get("trajectory_length")
            if t and shape[0] in (-1, None, 0):
                shape[0] = int(t)
        out[key] = data.reshape(shape)
    return out


def read_h5_trajectory(h5_path: str, traj_key: str, meta: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Open ``h5_path`` and read trajectory ``traj_key``."""
    with open_h5(h5_path) as f:
        return load_meta_trajectory(f, traj_key, meta)


def frame_to_sample(
    traj: Dict[str, np.ndarray],
    frame: int,
    meta: Dict[str, Any],
    frame_target: Optional[int] = None,
) -> RawSample:
    """One frame -> RawSample: node features are every non-geometry field at
    ``frame`` plus node_type (frame 0) plus a trailing time column; targets
    are the dynamic fields (or ``meta["target_features"]``) at
    ``frame_target``."""
    feats = meta["features"]

    def at_frame(key: str, fr: int) -> np.ndarray:
        # a static field stored without the time axis ([N, k]) is used as
        # is; a tiled static field reads frame 0
        a = traj[key]
        if feats.get(key, {}).get("type") == "static":
            return a[0] if a.ndim > 2 else a
        return a[fr]

    target_point_data = None
    if frame_target is not None:
        names = meta.get("target_features")
        if names is None:
            target_point_data = {
                key: traj[key][frame_target]
                for key, field in feats.items()
                if field["type"] == "dynamic"
            }
        else:
            target_point_data = {key: at_frame(key, frame_target) for key in names}

    point_data = {
        key: at_frame(key, frame)
        for key in traj.keys()
        if key not in ("mesh_pos", "cells", "node_type")
    }
    if "node_type" in traj:
        nt = traj["node_type"]
        static_untiled = feats.get("node_type", {}).get("type") == "static" and nt.ndim == 2
        point_data["node_type"] = nt if static_untiled else nt[0]

    mesh_pos = traj["mesh_pos"][frame] if traj["mesh_pos"].ndim > 2 else traj["mesh_pos"]
    cells = traj["cells"][frame] if traj["cells"].ndim > 2 else traj["cells"]
    return meshdata_to_sample(
        points=mesh_pos,
        cells=cells,
        point_data=point_data,
        time=frame * meta.get("dt", 1),
        target=target_point_data,
    )


def frame_item(
    traj: Dict[str, np.ndarray],
    frame: int,
    meta: Dict[str, Any],
    traj_index: int,
    use_previous_data: bool = False,
) -> RawSample:
    """The raw item of ``frame`` of trajectory ``traj_index``: its sample
    with the next frame as target and, with ``use_previous_data``, the
    previous frame's ``x``. h5 trajectories have no mesh name: ``id`` stays
    None."""
    sample = frame_to_sample(traj, frame, meta, frame_target=frame + 1)
    if use_previous_data:
        sample.previous_data = frame_to_sample(traj, frame - 1, meta).x
    sample.traj_index = traj_index
    return sample


class H5Dataset(BaseDataset):
    """Frames of the trajectories of one h5 file, one group per trajectory,
    laid out per the meta (``BaseDataset`` for the item pipeline). The file
    handle opens at first read and the last ``TRAJ_CACHE_SIZE``
    trajectories stay in memory."""

    def __init__(
        self,
        h5_path: str,
        meta_path: str,
        switch_to_val: bool = False,
        **kwargs,
    ):
        super().__init__(meta_path=meta_path, **kwargs)
        if switch_to_val:
            # the last "train" only: a whole-path replace would corrupt a
            # directory whose name contains it
            i = h5_path.rfind("train")
            if i >= 0:
                h5_path = h5_path[:i] + "test" + h5_path[i + 5 :]
        self.h5_path = h5_path
        self.dt = self.meta.get("dt", 1) or 1
        self._file = None
        self._traj_cache: OrderedDict = OrderedDict()
        with open_h5(h5_path) as f:
            self.datasets_index: List[str] = list(f.keys())

    @property
    def size_dataset(self) -> int:
        return len(self.datasets_index)

    def _handle(self):
        if self._file is None:
            self._file = open_h5(self.h5_path)
        return self._file

    def _trajectory(self, traj_index: int) -> Dict[str, np.ndarray]:
        if traj_index in self._traj_cache:
            self._traj_cache.move_to_end(traj_index)
            return self._traj_cache[traj_index]
        traj = load_meta_trajectory(self._handle(), self.datasets_index[traj_index], self.meta)
        self._traj_cache[traj_index] = traj
        while len(self._traj_cache) > TRAJ_CACHE_SIZE:
            self._traj_cache.popitem(last=False)
        return traj

    def scan_node_counts(self) -> List[int]:
        """Each trajectory's node count from the shape of its ``mesh_pos``."""
        f = self._handle()
        shape_meta = self.meta["features"]["mesh_pos"]["shape"]
        d = shape_meta[-1]
        counts = []
        for key in self.datasets_index:
            arr = f[key]["mesh_pos"]
            if arr.ndim == len(shape_meta) and arr.ndim >= 2 and arr.shape[-1] == d:
                n = arr.shape[-2]
            elif len(shape_meta) == 2:
                n = int(np.prod(arr.shape)) // d  # static mesh_pos stored flat
            else:
                # flat dynamic layout: elements / (T * d), T from the meta
                t = shape_meta[0] if shape_meta[0] and shape_meta[0] > 0 else self.trajectory_length
                n = int(np.prod(arr.shape)) // (t * d)
            counts.append(int(n))
        return counts

    def _load(self, index: int) -> RawSample:
        traj_index, frame = self.get_traj_frame(index)
        return frame_item(self._trajectory(traj_index), frame, self.meta, traj_index,
                          self.use_previous_data)

    def close(self) -> None:
        """Close the h5 handle (reopened at the next read)."""
        if self._file is not None:
            self._file.close()
            self._file = None

    def __getstate__(self):
        """The dataset without its open handle and trajectory cache: a
        loader worker unpickles its own copy and opens the file itself (an
        HDF5 handle cannot be shared across processes)."""
        state = dict(self.__dict__)
        state["_file"] = None
        state["_traj_cache"] = OrderedDict()
        return state


class MemoryDataset(BaseDataset):
    """Frames of trajectories held in memory: each a dict of arrays as
    ``load_meta_trajectory`` reads one from an h5 file (static fields may
    lie untiled, without the time axis), laid out per the meta at
    ``meta_path``. The h5 dataset without the file, for a machine without
    ``h5py`` or data made at run time."""

    def __init__(self, trajectories: Sequence[Dict[str, np.ndarray]], meta_path: str, **kwargs):
        super().__init__(meta_path=meta_path, **kwargs)
        self.trajectories = list(trajectories)
        self.dt = self.meta.get("dt", 1) or 1

    @property
    def size_dataset(self) -> int:
        return len(self.trajectories)

    def scan_node_counts(self) -> List[int]:
        return [int(t["mesh_pos"].shape[-2]) for t in self.trajectories]

    def _load(self, index: int) -> RawSample:
        traj_index, frame = self.get_traj_frame(index)
        return frame_item(self.trajectories[traj_index], frame, self.meta, traj_index,
                          self.use_previous_data)

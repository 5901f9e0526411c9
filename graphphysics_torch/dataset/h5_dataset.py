"""H5 trajectories (counterpart of the trajectory readers in
``graphphysics_tpu/dataset/h5_dataset.py``): read one trajectory per the
meta schema and turn a frame into a ``RawSample``. ``h5py`` is imported only
by the function that opens a file."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from graphphysics_torch.dataset.sample import RawSample, meshdata_to_sample


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
    import h5py

    with h5py.File(h5_path, "r") as f:
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

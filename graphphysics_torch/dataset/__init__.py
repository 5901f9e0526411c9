from graphphysics_torch.dataset.dataset import EDGE_LAYOUTS, BaseDataset
from graphphysics_torch.dataset.h5_dataset import (
    H5Dataset,
    MemoryDataset,
    frame_to_sample,
    load_meta_trajectory,
    read_h5_trajectory,
)
from graphphysics_torch.dataset.loader import GraphLoader
from graphphysics_torch.dataset.preprocessing import (
    Pipeline,
    add_noise,
    add_obstacles_next_pos,
    add_world_edges,
    add_world_pos_features,
    build_preprocessing,
    random_3d_rotate,
)
from graphphysics_torch.dataset.sample import RawSample, meshdata_to_sample
from graphphysics_torch.dataset.xdmf_dataset import XDMFDataset

__all__ = [
    "EDGE_LAYOUTS",
    "BaseDataset",
    "GraphLoader",
    "H5Dataset",
    "MemoryDataset",
    "Pipeline",
    "RawSample",
    "XDMFDataset",
    "add_noise",
    "add_obstacles_next_pos",
    "add_world_edges",
    "add_world_pos_features",
    "build_preprocessing",
    "frame_to_sample",
    "load_meta_trajectory",
    "meshdata_to_sample",
    "random_3d_rotate",
    "read_h5_trajectory",
]

from graphphysics_torch.dataset.dataset import EDGE_LAYOUTS, BaseDataset
from graphphysics_torch.dataset.h5_dataset import (
    H5Dataset,
    frame_to_sample,
    load_meta_trajectory,
    read_h5_trajectory,
)
from graphphysics_torch.dataset.loader import GraphLoader
from graphphysics_torch.dataset.preprocessing import Pipeline, add_noise, build_preprocessing
from graphphysics_torch.dataset.sample import RawSample, meshdata_to_sample
from graphphysics_torch.dataset.xdmf_dataset import XDMFDataset

__all__ = [
    "EDGE_LAYOUTS",
    "BaseDataset",
    "GraphLoader",
    "H5Dataset",
    "Pipeline",
    "RawSample",
    "XDMFDataset",
    "add_noise",
    "build_preprocessing",
    "frame_to_sample",
    "load_meta_trajectory",
    "meshdata_to_sample",
    "read_h5_trajectory",
]

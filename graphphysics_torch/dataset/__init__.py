from graphphysics_torch.dataset.h5_dataset import (
    frame_to_sample,
    load_meta_trajectory,
    read_h5_trajectory,
)
from graphphysics_torch.dataset.preprocessing import Pipeline, build_preprocessing
from graphphysics_torch.dataset.sample import RawSample, meshdata_to_sample

__all__ = [
    "Pipeline",
    "RawSample",
    "build_preprocessing",
    "frame_to_sample",
    "load_meta_trajectory",
    "meshdata_to_sample",
    "read_h5_trajectory",
]

from graphphysics_torch.training.parse_parameters import (
    get_model,
    get_preprocessing,
    get_simulator,
    get_simulator_config,
)
from graphphysics_torch.training.rollout import (
    build_mask,
    rollout,
    rollout_rmse,
    stacked_trajectory,
)

__all__ = [
    "build_mask",
    "get_model",
    "get_preprocessing",
    "get_simulator",
    "get_simulator_config",
    "rollout",
    "rollout_rmse",
    "stacked_trajectory",
]

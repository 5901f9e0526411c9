from graphphysics_torch.training.checkpoint import (
    is_torch_checkpoint,
    load_checkpoint,
    load_checkpoint_with_metadata,
    load_metadata,
    save_checkpoint,
)
from graphphysics_torch.training.losses import (
    diagonal_gmm_nll_loss,
    diagonal_gmm_nll_per_row,
    gmm_nll_loss,
    gmm_nll_per_row,
    l1_smooth_loss,
    l2_loss,
    make_local_loss,
    node_type_mask,
)
from graphphysics_torch.training.parse_parameters import (
    edge_layout,
    get_dataset,
    get_model,
    get_preprocessing,
    get_simulator,
    get_simulator_config,
    gmm_options,
    model_options,
)
from graphphysics_torch.training.rollout import (
    build_mask,
    rollout,
    rollout_rmse,
    stacked_trajectory,
)
from graphphysics_torch.training.schedule import cosine_warmup_schedule
from graphphysics_torch.training.trainer import Trainer

__all__ = [
    "Trainer",
    "build_mask",
    "cosine_warmup_schedule",
    "diagonal_gmm_nll_loss",
    "diagonal_gmm_nll_per_row",
    "edge_layout",
    "get_dataset",
    "get_model",
    "get_preprocessing",
    "get_simulator",
    "get_simulator_config",
    "gmm_nll_loss",
    "gmm_nll_per_row",
    "gmm_options",
    "model_options",
    "is_torch_checkpoint",
    "l1_smooth_loss",
    "l2_loss",
    "load_checkpoint",
    "load_checkpoint_with_metadata",
    "load_metadata",
    "make_local_loss",
    "node_type_mask",
    "rollout",
    "rollout_rmse",
    "save_checkpoint",
    "stacked_trajectory",
]

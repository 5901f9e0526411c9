from graphphysics_torch.training.rollout import (
    build_mask,
    rollout,
    rollout_rmse,
    stacked_trajectory,
)

__all__ = ["build_mask", "rollout", "rollout_rmse", "stacked_trajectory"]

from graphphysics_torch.models.gmm import (
    gmm_diagonal_from_draws,
    gmm_full_from_draws,
    sample_gmm,
    sample_gmm_diagonal,
)
from graphphysics_torch.models.layers import (
    MLP,
    Attention,
    DiagonalGMMHead,
    GatedMLP,
    GatedMLPBlock,
    GMMHead,
    GraphNetBlock,
    RMSNorm,
    TransformerBlock,
    reset_parameters,
)
from graphphysics_torch.models.processors import EncodeProcessDecode, EncodeTransformDecode
from graphphysics_torch.models.simulator import Normalizer, Simulator, SimulatorConfig

__all__ = [
    "MLP",
    "Attention",
    "DiagonalGMMHead",
    "EncodeProcessDecode",
    "EncodeTransformDecode",
    "GatedMLP",
    "GatedMLPBlock",
    "GMMHead",
    "GraphNetBlock",
    "Normalizer",
    "RMSNorm",
    "Simulator",
    "SimulatorConfig",
    "TransformerBlock",
    "gmm_diagonal_from_draws",
    "gmm_full_from_draws",
    "reset_parameters",
    "sample_gmm",
    "sample_gmm_diagonal",
]

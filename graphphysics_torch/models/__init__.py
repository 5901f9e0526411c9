from graphphysics_torch.models.layers import (
    MLP,
    Attention,
    GatedMLP,
    GatedMLPBlock,
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
    "EncodeProcessDecode",
    "EncodeTransformDecode",
    "GatedMLP",
    "GatedMLPBlock",
    "GraphNetBlock",
    "Normalizer",
    "RMSNorm",
    "Simulator",
    "SimulatorConfig",
    "TransformerBlock",
    "reset_parameters",
]

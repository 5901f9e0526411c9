from graphphysics_torch.models.layers import MLP, GraphNetBlock, RMSNorm, reset_parameters
from graphphysics_torch.models.processors import EncodeProcessDecode
from graphphysics_torch.models.simulator import Normalizer, Simulator, SimulatorConfig

__all__ = [
    "MLP",
    "EncodeProcessDecode",
    "GraphNetBlock",
    "Normalizer",
    "RMSNorm",
    "Simulator",
    "SimulatorConfig",
    "reset_parameters",
]

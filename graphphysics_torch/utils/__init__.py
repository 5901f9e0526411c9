from graphphysics_torch.utils.metrics import AverageValueMeter, CSVMetricsLogger, WandbLogger
from graphphysics_torch.utils.progress import ProgressReporter
from graphphysics_torch.utils.xdmf import XdmfTimeSeriesReader, XdmfTimeSeriesWriter

__all__ = [
    "AverageValueMeter",
    "CSVMetricsLogger",
    "ProgressReporter",
    "WandbLogger",
    "XdmfTimeSeriesReader",
    "XdmfTimeSeriesWriter",
]

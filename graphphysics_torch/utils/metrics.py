"""Metrics sinks (counterpart of ``graphphysics_tpu/utils/metrics.py``): an
online meter, the CSV logger the ``Trainer`` writes through, and an optional
W&B logger."""

from __future__ import annotations

import csv
import math
import os
import time
from typing import Dict, Optional


class AverageValueMeter:
    """Online mean and standard deviation of scalar observations."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.var = 0.0
        self.val = 0.0
        self.mean = math.nan
        self.std = math.nan

    def add(self, value: float, n: int = 1):
        self.val = value
        self.sum += value * n
        self.var += value * value * n
        self.n += n
        if self.n == 0:
            self.mean, self.std = math.nan, math.nan
        elif self.n == 1:
            self.mean, self.std = self.sum, math.inf
        else:
            self.mean = self.sum / self.n
            var = (self.var - self.n * self.mean * self.mean) / (self.n - 1.0)
            self.std = math.sqrt(max(var, 0.0))

    def value(self):
        return self.mean, self.std


class CSVMetricsLogger:
    """CSV metrics file with columns ``time, epoch, step`` and then each
    metric key in the order it first appears. A new key widens the header
    and the file is rewritten under it (earlier rows leave it empty); a
    logger opened on an existing file (a resumed run) adopts its header."""

    def __init__(self, path: str):
        self.path = path
        self._fields = ["time", "epoch", "step"]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if os.path.exists(path):
            with open(path, newline="") as f:
                header = next(csv.reader(f), None)
            if header:
                self._fields = list(header)

    def _rewrite_with_fields(self):
        rows = []
        if os.path.exists(self.path):
            with open(self.path, newline="") as f:
                rows = list(csv.DictReader(f))
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            w.writeheader()
            w.writerows(rows)

    def log(self, epoch: int, step: int, metrics: Dict[str, float]):
        new_fields = [k for k in metrics if k not in self._fields]
        if new_fields or not os.path.exists(self.path):
            self._fields.extend(new_fields)
            self._rewrite_with_fields()
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fields, extrasaction="ignore")
            w.writerow({"time": f"{time.time():.3f}", "epoch": epoch, "step": step, **metrics})


class WandbLogger:
    """Optional W&B sink; disabled (``run`` and ``run_id`` None) when wandb
    is not installed or its run cannot start."""

    def __init__(self, project: str, config: Optional[dict] = None, run_id: Optional[str] = None):
        try:
            import wandb

            self.run = wandb.init(
                project=project, config=config, id=run_id, resume="allow" if run_id else None
            )
            self.run_id = self.run.id
        except Exception:
            self.run = None
            self.run_id = None

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        if self.run is not None:
            self.run.log(metrics, step=step)

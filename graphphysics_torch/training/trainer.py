"""Single-device training (counterpart of the single-device part of
``graphphysics_tpu/training/trainer.py``): the Simulator of a training
config, AdamW with the cosine-warmup schedule, the train step, ``fit`` over a
``GraphLoader`` and rollout validation.

The optimizer is ``torch.optim.AdamW`` with betas (0.9, 0.95), eps 1e-8 and
weight decay 1e-4 on every parameter, biases and RMSNorm scales included, as
optax's unmasked ``adamw``: the decay is decoupled and scaled by the
learning rate, eps sits outside the square root, the bias correction starts
at step 1. Its base learning rate is 1 and a ``LambdaLR`` of the schedule,
stepped after each optimizer step, sets the rate, so the first update uses
``schedule(0)`` as optax's step count does. The train step runs eagerly on
``device`` (``cuda`` unless named): on the card the segment sums and the
attention, forward and backward, are the hand-written kernels of
``graphphysics_torch/csrc``.

Data parallelism, graph partitioning, gradient accumulation, profiling,
checkpoints, resume and ``predict`` come with later slices: asking for one
raises ``NotImplementedError``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import torch

from graphphysics_torch.core.device import DeviceLike, resolve_device
from graphphysics_torch.core.graph import Graph, stack_graphs
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.models.layers import reset_parameters
from graphphysics_torch.training.losses import l2_loss
from graphphysics_torch.training.parse_parameters import get_simulator
from graphphysics_torch.training.rollout import rollout, rollout_rmse
from graphphysics_torch.training.schedule import cosine_warmup_schedule

BETAS = (0.9, 0.95)
EPS = 1e-8
WEIGHT_DECAY = 1e-4

# options of the JAX Trainer that the port does not have yet, with the value
# that leaves them off
_NOT_PORTED = {
    "use_previous_data": False,
    "previous_data_start": None,
    "previous_data_end": None,
    "checkpoint_dir": None,
    "checkpoint_name": None,
    "rollout_dir": None,
    "extra_logger": None,
    "plot_callback": None,
    "data_parallel": False,
    "gradient_accumulation": False,
    "graph_partition": 0,
    "partition_mode": None,
    "partition_edge_headroom": None,
    "partition_budget_growth": None,
    "partition_reorder": None,
    "partition_overlap_attention": None,
    "halo_dtype": None,
    "partitioned_validation": False,
    "num_devices": None,
    "save_every_n_steps": None,
    "checkpoint_backend": None,
    "profile_dir": None,
    "profile_start_step": None,
    "profile_num_steps": None,
    "parallel_validation": None,
    "progress": None,
}


class Trainer:
    """Trains the Simulator of ``parameters`` (a training config) on one
    device. ``masks`` are the node types the loss covers, ``seed`` draws the
    initial weights, ``log_every`` steps write ``train_loss`` and ``lr`` to
    ``metrics_path`` (JSON lines; nothing is written without it)."""

    def __init__(
        self,
        parameters: Dict[str, Any],
        learning_rate: float = 1e-3,
        warmup: int = 1000,
        num_steps: Optional[int] = None,
        masks: Sequence[int] = (NodeType.NORMAL, NodeType.OUTFLOW),
        seed: int = 42,
        log_every: int = 100,
        metrics_path: Optional[str] = None,
        device: DeviceLike = None,
        **options: Any,
    ):
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Trainer got an unexpected argument {name!r}")
            if value != _NOT_PORTED[name]:
                raise NotImplementedError(
                    f"Trainer option {name!r} is not ported yet (ROADMAP.md section 1)"
                )
        self.param = parameters
        self.learning_rate = learning_rate
        self.warmup = warmup
        self.num_steps = num_steps
        self.masks = [int(m) for m in masks]
        self.seed = seed
        self.log_every = log_every
        self.metrics_path = metrics_path
        self.device = resolve_device(device)
        self.sim = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler = None
        self.schedule = None
        self.step = 0

    def init_state(self, num_steps: int) -> None:
        """The Simulator of the config with weights drawn from
        ``torch.Generator().manual_seed(seed)``, zero normalizer statistics,
        and AdamW with a ``num_steps``-long schedule, on the device."""
        sim = get_simulator(self.param, device="cpu")
        reset_parameters(sim.model, torch.Generator().manual_seed(self.seed))
        self.sim = sim.to(self.device)
        self.schedule = cosine_warmup_schedule(self.learning_rate, self.warmup, num_steps)
        self.optimizer = torch.optim.AdamW(
            self.sim.parameters(), lr=1.0, betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY
        )
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, self.schedule)
        self.step = 0

    def train_step(self, graph: Graph) -> torch.Tensor:
        """One optimizer step on ``graph`` (host or device); returns the
        step's loss as a 0-d tensor on the device, not synchronized."""
        if self.optimizer is None:
            raise RuntimeError("call init_state (or fit) before train_step")
        self.sim.train()
        graph = graph.to(self.device)
        # the training forward folds the batch into the normalizers first
        out, target, _ = self.sim(graph, is_training=True)
        loss = l2_loss(
            target, out, self.sim.node_type(graph), self.masks,
            node_valid=graph.node_mask, exclude_mask=graph.exclude_mask,
        )
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return loss.detach()

    def fit(self, train_loader, val_dataset=None, num_epochs: int = 1,
            val_trajectories: Optional[int] = None) -> Dict[str, Any]:
        """``num_epochs`` epochs over ``train_loader``, each followed by a
        rollout validation on ``val_dataset`` when one is given. Returns
        ``{"train_loss": [per-epoch mean], "val_rmse": [per epoch]}``."""
        if self.optimizer is None:
            self.init_state(self.num_steps or num_epochs * len(train_loader))
        history: Dict[str, Any] = {"train_loss": [], "val_rmse": []}
        for epoch in range(num_epochs):
            train_loader.set_epoch(epoch)
            t0, nsteps, loss_sum = time.time(), 0, None
            for batch in train_loader:
                loss = self.train_step(batch)
                nsteps += 1
                loss_sum = loss if loss_sum is None else loss_sum + loss
                if self.step % self.log_every == 0:
                    self._log(epoch, {"train_loss": float(loss), "lr": self.schedule(self.step)})
            train_loss = float(loss_sum) / nsteps if nsteps else 0.0
            history["train_loss"].append(train_loss)
            msg = (
                f"[trainer] epoch {epoch}: train_loss={train_loss:.5f} "
                f"({nsteps} steps, {nsteps / max(time.time() - t0, 1e-9):.2f} it/s)"
            )
            if val_dataset is not None:
                val_rmse = self.validate(val_dataset, val_trajectories)
                history["val_rmse"].append(val_rmse)
                msg += f" val_all_rollout_rmse={val_rmse:.5f}"
                self._log(epoch, {"train_loss_epoch": train_loss, "val_all_rollout_rmse": val_rmse})
            print(msg)
        return history

    def validate(self, val_dataset, max_trajectories: Optional[int] = None) -> float:
        """The all-rollout RMSE of autoregressive rollouts over the first
        ``max_trajectories`` trajectories of ``val_dataset`` (all by
        default): one RMSE over every step of every trajectory."""
        n_traj = val_dataset.size_dataset
        if max_trajectories is not None:
            n_traj = min(n_traj, max_trajectories)
        self.sim.eval()
        total_se, total_cnt = 0.0, 0.0
        for traj in range(n_traj):
            frames = stack_graphs([val_dataset[i] for i in val_dataset.trajectory_indices(traj)])
            node_mask = torch.as_tensor(frames.node_mask[0]).to(self.device)
            preds, targets = rollout(self.sim, frames, device=self.device)
            rmse = float(rollout_rmse(preds, targets, node_mask))
            cnt = float(node_mask.sum()) * preds.shape[0] * preds.shape[-1]
            total_se += rmse**2 * cnt
            total_cnt += cnt
        return float((total_se / max(total_cnt, 1.0)) ** 0.5)

    def _log(self, epoch: int, metrics: Dict[str, float]) -> None:
        if self.metrics_path is None:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.metrics_path)), exist_ok=True)
        with open(self.metrics_path, "a") as fp:
            fp.write(json.dumps({"epoch": epoch, "step": self.step, **metrics}) + "\n")

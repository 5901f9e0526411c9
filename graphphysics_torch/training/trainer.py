"""Single-device training (counterpart of the single-device part of
``graphphysics_tpu/training/trainer.py``): the Simulator of a training
config, AdamW with the cosine-warmup schedule, the train step, ``fit`` over a
``GraphLoader`` with checkpoints, preemption and resume, rollout validation
with its XDMF export, and ``predict``.

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

A GMM head (``num_mixture_components`` K > 0 in the model config) trains
on its negative log-likelihood, diagonal or, with ``"use_diagonal": false``,
full covariance, at the config's temperature. Its rollouts sample: each
trajectory draws from its own ``torch.Generator`` on the device, seeded from
``(seed + epoch, trajectory)`` in ``validate`` and ``(seed, trajectory)`` in
``predict`` (``trajectory_generator``), so a trajectory's draws do not
depend on which others are rolled out, and ``val_loss`` is None.

Checkpoints are ``training/checkpoint.py`` files. ``fit`` saves after every
epoch, every ``save_every_n_steps`` steps when asked, and at the next step
boundary after a SIGTERM or SIGINT (a second signal aborts at once); the
mid-epoch saves record the batch offset, and ``fit(resume_from=)`` replays
the loader's deterministic stream from there, so a resumed run ends where
the uninterrupted one does. A mid-epoch save also records the epoch's loss
sum so far, so the resumed epoch reports the mean over all its batches.

With ``use_previous_data`` the rollouts of ``validate`` and ``predict``
feed ``x[:, previous_data_start:previous_data_end]`` (``rollout``), and the
written rollout series start at ``2 * dt``: the first frame with a frame
before it.

With ``gradient_accumulation`` each batch is a stacked ``[M, ...]`` Graph
(``GraphLoader(collate="stack")``) whose M microbatches make one optimizer
step (``training/microbatch.py``): one microbatch's activations alive at a
time, the statistics and the loss those of the concatenation.

Batches and trajectories come in the dataset's layout: sorted, CSR or ELL,
padded to one budget or, with size buckets, each to its bucket's (a
trajectory's frames share one). Data parallelism, graph partitioning and
the profiler are not ported yet: asking for one raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from graphphysics_torch.core.device import DeviceLike, resolve_device
from graphphysics_torch.core.graph import Graph, stack_graphs
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.models.layers import reset_parameters
from graphphysics_torch.training.checkpoint import load_checkpoint_with_metadata, save_checkpoint
from graphphysics_torch.training.losses import (
    diagonal_gmm_nll_loss,
    gmm_nll_loss,
    l2_loss,
    make_local_loss,
)
from graphphysics_torch.training.microbatch import gmm_kwargs, loss_kind, microbatch_step
from graphphysics_torch.training.parse_parameters import get_simulator, gmm_options
from graphphysics_torch.training.rollout import rollout, rollout_rmse
from graphphysics_torch.training.schedule import cosine_warmup_schedule
from graphphysics_torch.utils.metrics import CSVMetricsLogger
from graphphysics_torch.utils.progress import ProgressReporter
from graphphysics_torch.utils.xdmf import XdmfTimeSeriesWriter

BETAS = (0.9, 0.95)
EPS = 1e-8
WEIGHT_DECAY = 1e-4

# options of the JAX Trainer that the port does not have yet: the value
# that leaves each off, and the ROADMAP.md section 1 item that brings it
_NOT_PORTED = {
    "data_parallel": (False, 13),
    "graph_partition": (0, 14),
    "partition_mode": (None, 14),
    "partition_edge_headroom": (None, 14),
    "partition_budget_growth": (None, 14),
    "partition_reorder": (None, 14),
    "partition_overlap_attention": (None, 14),
    "halo_dtype": (None, 14),
    "partitioned_validation": (False, 14),
    "num_devices": (None, 13),
    "checkpoint_backend": ("torch", 4),  # the orbax backends
    "plot_callback": (None, 12),
    "profile_dir": (None, 12),
    "profile_start_step": (None, 12),
    "profile_num_steps": (None, 12),
    "parallel_validation": (None, 13),
}


def trajectory_generator(seed: int, trajectory: int, device: DeviceLike = None) -> torch.Generator:
    """The generator of one trajectory's sampled rollout on ``device``
    (``cuda`` unless named): seeded from ``SeedSequence([seed, trajectory])``,
    a function of the two numbers only."""
    hi, lo = np.random.SeedSequence([seed, trajectory]).generate_state(2, np.uint32)
    return torch.Generator(device=resolve_device(device)).manual_seed(int(hi) << 32 | int(lo))


class Trainer:
    """Trains the Simulator of ``parameters`` (a training config) on one
    device. ``masks`` are the node types the loss covers, ``seed`` draws the
    initial weights. Every ``log_every`` steps ``train_loss`` and ``lr``,
    and after each validation ``train_loss_epoch``,
    ``val_all_rollout_rmse`` and ``val_loss``, go to the CSV file
    ``metrics_path`` and to ``extra_logger`` (``.log(metrics, step=)``),
    where given. Checkpoints go to ``checkpoint_dir/checkpoint_name``, the
    XDMF rollout of validation trajectory 0 under ``rollout_dir`` (none
    without it). ``gradient_accumulation`` takes stacked batches, one
    optimizer step over their microbatches."""

    def __init__(
        self,
        parameters: Dict[str, Any],
        learning_rate: float = 1e-3,
        warmup: int = 1000,
        num_steps: Optional[int] = None,
        masks: Sequence[int] = (NodeType.NORMAL, NodeType.OUTFLOW),
        use_previous_data: bool = False,
        previous_data_start: Optional[int] = None,
        previous_data_end: Optional[int] = None,
        checkpoint_dir: str = "checkpoints",
        checkpoint_name: str = "state.pt",
        metrics_path: Optional[str] = "metrics.csv",
        rollout_dir: Optional[str] = "meshes",
        seed: int = 42,
        log_every: int = 100,
        extra_logger=None,
        save_every_n_steps: Optional[int] = None,
        progress: Optional[bool] = None,
        device: DeviceLike = None,
        gradient_accumulation: bool = False,
        **options: Any,
    ):
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"Trainer got an unexpected argument {name!r}")
            off, item = _NOT_PORTED[name]
            if value != off:
                raise NotImplementedError(
                    f"Trainer option {name!r} is not ported yet (ROADMAP.md section 1, item {item})"
                )
        self.device = resolve_device(device)
        self.param = parameters
        self.learning_rate = learning_rate
        self.warmup = warmup
        self.num_steps = num_steps
        self.masks = [int(m) for m in masks]
        self.use_previous_data = use_previous_data
        self.previous_data_start = previous_data_start
        self.previous_data_end = previous_data_end
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_name = checkpoint_name
        self.metrics = CSVMetricsLogger(metrics_path) if metrics_path else None
        self.rollout_dir = rollout_dir
        self.seed = seed
        gmm = gmm_options(parameters)
        self.K = gmm["num_mixture_components"]
        self.d = parameters["model"]["output_size"]
        self.temperature = 1.0 if gmm["temperature"] is None else gmm["temperature"]
        self.use_diagonal = gmm["use_diagonal"]
        self.log_every = log_every
        self.extra_logger = extra_logger
        self.save_every_n_steps = save_every_n_steps
        self.progress = progress
        self.gradient_accumulation = bool(gradient_accumulation)
        self._local_loss = make_local_loss(
            self.masks, loss_kind(self.K, self.use_diagonal), gmm_kwargs(self.K, self.d, self.temperature)
        )
        self.sim = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.scheduler = None
        self.schedule = None
        self.step = 0
        self.last_val_loss: Optional[float] = None
        self._interrupt_requested = False

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
        """One optimizer step on ``graph`` (host or device): a flat batch,
        or with ``gradient_accumulation`` a stacked one, each of its
        microbatches in turn. Returns the step's loss as a 0-d tensor on the
        device, not synchronized."""
        if self.optimizer is None:
            raise RuntimeError("call init_state (or fit) before train_step")
        self.sim.train()
        graph = graph.to(self.device)
        if self.gradient_accumulation:
            if graph.x.dim() != 3:
                raise ValueError(
                    "gradient_accumulation takes stacked [M, N, F] batches: "
                    "GraphLoader(collate='stack')"
                )
            loss = microbatch_step(self.sim, self.optimizer, graph, self._local_loss)
        else:
            # the training forward folds the batch into the normalizers first
            out, target, _ = self.sim(graph, is_training=True)
            loss = self.loss(target, out, graph)
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return loss.detach()

    def loss(self, target: torch.Tensor, out: torch.Tensor, graph: Graph) -> torch.Tensor:
        """The training loss of one batch: the masked L2 for the plain
        decoder, the masked GMM NLL (diagonal or full) for a GMM head."""
        kw = dict(node_valid=graph.node_mask, exclude_mask=graph.exclude_mask)
        node_type = self.sim.node_type(graph)
        if self.K == 0:
            return l2_loss(target, out, node_type, self.masks, **kw)
        nll = diagonal_gmm_nll_loss if self.use_diagonal else gmm_nll_loss
        return nll(target, out, node_type, self.masks, d=self.d, K=self.K,
                   temperature=self.temperature, **kw)

    # ------------------------------------------------------------- training

    def fit(self, train_loader, val_dataset=None, num_epochs: int = 1,
            resume_from: Optional[str] = None,
            val_trajectories: Optional[int] = None) -> Dict[str, Any]:
        """``num_epochs`` epochs over ``train_loader``, each followed by a
        rollout validation on ``val_dataset`` when one is given and a save.
        ``resume_from`` (an existing checkpoint) restores the state and
        continues at its epoch and batch offset. Returns
        ``{"train_loss": [per-epoch mean], "val_rmse": [per epoch],
        "interrupted": bool}``."""
        num_steps = self.num_steps or num_epochs * len(train_loader)
        if self.optimizer is None:
            self.init_state(num_steps)
        start_epoch, resume_offset, resumed_loss = 0, 0, None
        if resume_from and os.path.exists(resume_from):
            _, meta = load_checkpoint_with_metadata(resume_from, self)
            start_epoch = int(meta.get("epoch", 0))
            resume_offset = int(meta.get("batch_offset", 0))
            if resume_offset and "epoch_loss_sum" in meta:
                resumed_loss = (meta["epoch_loss_sum"], int(meta["epoch_steps"]))
            print(f"[trainer] resumed from {resume_from} at epoch {start_epoch}"
                  + (f" batch {resume_offset}" if resume_offset else ""))

        prev_handlers = self._install_signal_handlers()
        history: Dict[str, Any] = {"train_loss": [], "val_rmse": [], "interrupted": False}
        try:
            for epoch in range(start_epoch, num_epochs):
                train_loader.set_epoch(epoch)
                offset = resume_offset if epoch == start_epoch else 0
                if offset:
                    # the loader's per-(seed, epoch, index) determinism makes
                    # the resumed stream the uninterrupted one's
                    train_loader.set_start_batch(offset)
                t0, nsteps = time.time(), 0
                # the epoch's loss sum stays on the device: no per-step sync
                loss_sum, steps_before = None, 0
                if offset and resumed_loss is not None:
                    loss_sum = torch.tensor(resumed_loss[0], dtype=torch.float32, device=self.device)
                    steps_before = resumed_loss[1]
                prog = ProgressReporter(len(train_loader) - offset, prefix=f"epoch {epoch}",
                                        enable=self.progress)
                for batch in train_loader:
                    loss = self.train_step(batch)
                    nsteps += 1
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                    if self.step % self.log_every == 0:
                        host_loss = float(loss)
                        self._log(epoch, self.step,
                                  {"train_loss": host_loss, "lr": self.schedule(self.step)})
                        prog.update(nsteps, loss=host_loss)
                    else:
                        prog.update(nsteps)
                    # read the flag once: a signal between a "save?" and a
                    # "stop?" read must not return without the checkpoint
                    stop = self._interrupt_requested
                    if stop or (self.save_every_n_steps and self.step % self.save_every_n_steps == 0):
                        self.save(epoch, batch_offset=offset + nsteps,
                                  epoch_loss=(loss_sum, steps_before + nsteps))
                    if stop:
                        prog.close()
                        print(f"[trainer] interrupted at epoch {epoch} batch {offset + nsteps}; "
                              f"checkpoint saved - resume with the same data order via "
                              f"--resume_training")
                        history["interrupted"] = True
                        return history
                prog.close()
                total = steps_before + nsteps
                train_loss = float(loss_sum) / total if total else 0.0
                history["train_loss"].append(train_loss)
                msg = (f"[trainer] epoch {epoch}: train_loss={train_loss:.5f} "
                       f"({nsteps} steps, {nsteps / max(time.time() - t0, 1e-9):.2f} it/s)")
                if val_dataset is not None:
                    val_rmse = self.validate(val_dataset, epoch, val_trajectories)
                    history["val_rmse"].append(val_rmse)
                    msg += f" val_all_rollout_rmse={val_rmse:.5f}"
                    metrics = {"train_loss_epoch": train_loss, "val_all_rollout_rmse": val_rmse}
                    if self.last_val_loss is not None:
                        metrics["val_loss"] = self.last_val_loss
                        msg += f" val_loss={self.last_val_loss:.5f}"
                    self._log(epoch, self.step, metrics)
                print(msg)
                self.save(epoch)
            return history
        finally:
            self._restore_signal_handlers(prev_handlers)

    def request_interrupt(self) -> None:
        """Ask ``fit`` to checkpoint and stop at the next step boundary (what
        the SIGTERM and SIGINT handlers call)."""
        self._interrupt_requested = True

    def _install_signal_handlers(self):
        prev = {}

        def handler(signum, frame):
            if self._interrupt_requested:
                # a second signal: stop waiting for a step boundary
                self._restore_signal_handlers(prev)
                raise KeyboardInterrupt(f"second signal {signum} during fit(); checkpoint may be stale")
            self.request_interrupt()
            print(f"[trainer] caught signal {signum}: will checkpoint and stop at the next step "
                  f"boundary (signal again to abort now)")

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread: no handlers
                pass
        return prev

    def _restore_signal_handlers(self, prev) -> None:
        self._interrupt_requested = False
        for sig, handler in prev.items():
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass

    # ----------------------------------------------------------- validation

    def _rollout_trajectory(self, dataset, traj: int, seed: int):
        """Trajectory ``traj`` rolled out; a GMM head samples from
        ``trajectory_generator(seed, traj)``."""
        frames = stack_graphs([dataset[i] for i in dataset.trajectory_indices(traj)]).to(self.device)
        gen = trajectory_generator(seed, traj, self.device) if self.K else None
        preds, targets = rollout(self.sim, frames, device=self.device, generator=gen,
                                 use_previous_data=self.use_previous_data,
                                 previous_data_start=self.previous_data_start,
                                 previous_data_end=self.previous_data_end)
        return frames, preds, targets

    def validate(self, val_dataset, epoch: int = 0, max_trajectories: Optional[int] = None,
                 save_rollout: bool = True) -> float:
        """Autoregressive rollouts of the first ``max_trajectories``
        trajectories of ``val_dataset`` (all by default). Returns the
        all-rollout RMSE (one RMSE over every step of every trajectory) and
        sets ``last_val_loss``, the mean over all steps of the masked L2 of
        each step's denormalized prediction (None for a GMM head, whose
        rollouts sample from ``trajectory_generator(seed + epoch, traj)``).
        Trajectory 0's rollout is written under ``rollout_dir`` when
        ``save_rollout``."""
        n_traj = val_dataset.size_dataset
        if max_trajectories is not None:
            n_traj = min(n_traj, max_trajectories)
        self.sim.eval()
        nti = self.sim.config.node_type_index
        total_se, total_cnt, vloss_sum, vloss_cnt = 0.0, 0.0, 0.0, 0
        prog = ProgressReporter(n_traj, prefix=f"validate epoch {epoch}", enable=self.progress)
        for traj in range(n_traj):
            frames, preds, targets = self._rollout_trajectory(val_dataset, traj, self.seed + epoch)
            node_mask = frames.node_mask[0]
            node_type = frames.x[0, :, nti].to(torch.int64)
            with torch.inference_mode():
                rmse = rollout_rmse(preds, targets, node_mask)
            cnt = float(node_mask.sum()) * preds.shape[0] * preds.shape[-1]
            total_se += float(rmse) ** 2 * cnt
            total_cnt += cnt
            if self.K == 0:
                with torch.inference_mode():
                    step_losses = torch.stack([
                        l2_loss(y, p, node_type, self.masks, node_valid=node_mask)
                        for p, y in zip(preds, targets)
                    ])
                vloss_sum += float(step_losses.sum())
                vloss_cnt += step_losses.shape[0]
            if traj == 0 and save_rollout and self.rollout_dir:
                self._save_rollout_xdmf(val_dataset, 0, preds.cpu().numpy(), epoch)
            prog.update(traj + 1)
        prog.close()
        self.last_val_loss = vloss_sum / vloss_cnt if vloss_cnt else None
        return float((total_se / max(total_cnt, 1.0)) ** 0.5)

    def _write_rollout_series(self, dataset, traj: int, preds: np.ndarray,
                              make_path: Callable[[str], str]) -> None:
        """Write a predicted trajectory as an XDMF time series on its raw
        mesh (its tetrahedra where it has them, else its triangles), the
        first frame at ``dt`` (``2 * dt`` with previous data) and one every
        ``dt`` of the dataset; ``make_path(name)`` maps the mesh's id (the
        trajectory number where the format has none) to the file."""
        raw = dataset._load(dataset.trajectory_indices(traj)[0])
        cells = raw.tetra if raw.tetra is not None else raw.faces
        name = raw.id if raw.id else str(traj)
        dt = getattr(dataset, "dt", 1.0) or 1.0
        with XdmfTimeSeriesWriter(make_path(name)) as w:
            w.write_points_cells(raw.pos, cells)
            t = 2 * dt if self.use_previous_data else dt
            for k in range(preds.shape[0]):
                w.write_data(t, {"prediction": preds[k, : raw.num_nodes]})
                t += dt

    def _save_rollout_xdmf(self, val_dataset, traj: int, preds: np.ndarray, epoch: int) -> None:
        try:
            save_dir = os.path.join(self.rollout_dir, f"epoch_{epoch}")
            os.makedirs(save_dir, exist_ok=True)
            self._write_rollout_series(
                val_dataset, traj, preds,
                lambda name: os.path.join(save_dir, f"graph_epoch_{epoch}_{name}.xdmf"),
            )
        except Exception as e:  # the export must never stop training
            print(f"[trainer] rollout export failed: {e}")

    # ------------------------------------------------------------- predict

    def predict(self, dataset, save_dir: Optional[str] = "predictions",
                max_trajectories: Optional[int] = None) -> List[np.ndarray]:
        """Roll out each of the first ``max_trajectories`` trajectories of
        ``dataset`` (all by default) and write each as
        ``save_dir/graph_{id}.xdmf``; ``save_dir=None`` writes nothing. A GMM
        head samples trajectory ``t`` from ``trajectory_generator(seed, t)``.
        Returns the ``[T, N, d]`` predictions on the host."""
        if self.sim is None:
            raise RuntimeError("call init_state and load a checkpoint before predict")
        n_traj = dataset.size_dataset
        if max_trajectories is not None:
            n_traj = min(n_traj, max_trajectories)
        self.sim.eval()
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
        out = []
        for traj in range(n_traj):
            preds = self._rollout_trajectory(dataset, traj, self.seed)[1].cpu().numpy()
            out.append(preds)
            if save_dir is not None:
                self._write_rollout_series(
                    dataset, traj, preds, lambda name: os.path.join(save_dir, f"graph_{name}.xdmf")
                )
        return out

    # ---------------------------------------------------------------- misc

    def save(self, epoch: int, batch_offset: Optional[int] = None, epoch_loss=None) -> None:
        """End-of-epoch save (``batch_offset=None``: resume at epoch + 1), or
        a mid-epoch save (resume at this epoch, skipping the first
        ``batch_offset`` batches of its stream). ``epoch_loss``, the
        epoch's ``(loss sum tensor, steps)`` so far, rides along with a
        mid-epoch save."""
        metadata = {
            "epoch": epoch + 1 if batch_offset is None else epoch,
            "step": int(self.step),
            "wandb_run_id": getattr(self.extra_logger, "run_id", None),
        }
        if batch_offset is not None:
            metadata["batch_offset"] = int(batch_offset)
            if epoch_loss is not None and epoch_loss[0] is not None:
                metadata["epoch_loss_sum"] = float(epoch_loss[0])
                metadata["epoch_steps"] = int(epoch_loss[1])
        save_checkpoint(os.path.join(self.checkpoint_dir, self.checkpoint_name), self,
                        metadata=metadata)

    def _log(self, epoch: int, step: int, metrics: Dict[str, float]) -> None:
        if self.metrics is not None:
            self.metrics.log(epoch, step, metrics)
        if self.extra_logger is not None:
            self.extra_logger.log(metrics, step=step)

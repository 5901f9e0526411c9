"""Checkpoint save and restore (counterpart of
``graphphysics_tpu/training/checkpoint.py``).

One ``torch.save`` file in the reference ``Simulator.save_checkpoint``
format, so the JAX package's ``load_checkpoint`` imports its weights and
normalizers unchanged:

    {"model": <Simulator state_dict: model.* weights and the normalizer
               buffers>,
     "_output_normalizer": {...}, "_node_normalizer": {...},
     "_edge_normalizer": {...} or None,
     # what the port adds, for resuming:
     "optimizer": <AdamW state_dict>, "scheduler": <LambdaLR state_dict>,
     "step": int, "metadata": dict or None}

Every tensor is moved to the CPU first, and the file holds only tensors,
numbers, strings, lists, tuples, dicts and None, so it loads under
``torch.load(weights_only=True)``. A save writes a temporary file and
``os.replace``s it, so a crash mid-write leaves the previous checkpoint
whole; the metadata rides inside the file (committed with the state by the
same replace) and in an advisory ``.meta.json`` sidecar.

``load_checkpoint`` restores a port file whole into a ``Trainer`` (weights,
normalizers, optimizer, schedule position, step) or its weights and
normalizers into a ``Simulator``. A plain reference file (the JAX package's
``export_reference_checkpoint``) restores weights and normalizers and leaves
the optimizer fresh, as the JAX package does with one. The JAX package's
msgpack and orbax checkpoints cross over through
``export_reference_checkpoint``; the orbax backends themselves are not
ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from graphphysics_torch.models.simulator import Simulator
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint

_NORMALIZERS = ("_output_normalizer", "_node_normalizer", "_edge_normalizer")
# the normalizer constants of the reference format (core/normalizer.py)
_MAX_ACCUMULATIONS = 10**5
_STD_EPSILON = 1e-8


def _cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return type(obj)((k, _cpu(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _parts(target: Any) -> Tuple[Simulator, Any]:
    """(simulator, trainer or None) of a ``Simulator`` or a ``Trainer``."""
    if isinstance(target, Simulator):
        return target, None
    if getattr(target, "sim", None) is None:
        raise RuntimeError("the Trainer has no state yet: call init_state (or fit) first")
    return target.sim, target


def _checkpoint_dict(target: Any, metadata: Optional[dict]) -> Dict[str, Any]:
    """The checkpoint of a ``Simulator`` or a ``Trainer`` as a dict of CPU
    tensors; a Simulator alone has no optimizer, schedule or step."""
    sim, trainer = _parts(target)
    model = _cpu(sim.state_dict())
    ckpt: Dict[str, Any] = {"model": model}
    for name in _NORMALIZERS:
        if getattr(sim, name) is None:
            ckpt[name] = None
            continue
        ckpt[name] = {
            "_max_accumulations": _MAX_ACCUMULATIONS,
            "_std_epsilon": _STD_EPSILON,
            **{stat: model[f"{name}.{stat}"]
               for stat in ("_acc_count", "_num_accumulations", "_acc_sum", "_acc_sum_squared")},
        }
    has_opt = trainer is not None and trainer.optimizer is not None
    ckpt["optimizer"] = _cpu(trainer.optimizer.state_dict()) if has_opt else None
    ckpt["scheduler"] = _cpu(trainer.scheduler.state_dict()) if has_opt else None
    ckpt["step"] = int(trainer.step) if trainer is not None else 0
    ckpt["metadata"] = metadata
    return ckpt


def save_checkpoint(path: str, target: Any, metadata: Optional[dict] = None) -> None:
    """Write the checkpoint of ``target`` (a ``Trainer`` or a
    ``Simulator``) to ``path`` atomically, with ``metadata`` inside it and
    in ``path + ".meta.json"``."""
    ckpt = _checkpoint_dict(target, metadata)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    if metadata is not None:
        # advisory: the embedded copy wins, the sidecar may lag one save
        # behind after a crash between the two replaces
        tmp_meta = path + ".meta.json.tmp"
        with open(tmp_meta, "w") as f:
            json.dump(metadata, f)
        os.replace(tmp_meta, path + ".meta.json")


def is_torch_checkpoint(path: str) -> bool:
    """True if ``path`` is a ``torch.save`` file: a zip archive, or a pickle
    stream (the legacy format)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic == b"PK" or (len(magic) == 2 and magic[0] == 0x80 and magic[1] < 0x10)


def _read(path: str) -> Dict[str, Any]:
    for cand in (path, path + ".next", path + ".old"):
        if os.path.isdir(cand):
            raise NotImplementedError(
                f"{path} is an orbax checkpoint directory of the JAX package: the orbax "
                f"backends are not ported (ROADMAP.md section 1, item 4); write a reference "
                f"file from JAX with graphphysics_tpu.utils.torch_import.export_reference_checkpoint"
            )
    if not is_torch_checkpoint(path):
        raise ValueError(
            f"{path} is not a torch.save file (a JAX msgpack checkpoint?); write a reference "
            f"file from JAX with graphphysics_tpu.utils.torch_import.export_reference_checkpoint"
        )
    return torch.load(path, map_location="cpu", weights_only=True)


def _sidecar(path: str) -> dict:
    meta_path = path + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def _restore(ckpt: Dict[str, Any], target: Any) -> None:
    sim, trainer = _parts(target)
    load_reference_checkpoint(sim, ckpt)
    if trainer is None or ckpt.get("optimizer") is None:
        return  # a plain reference file: the optimizer stays fresh
    trainer.optimizer.load_state_dict(ckpt["optimizer"])
    trainer.scheduler.load_state_dict(ckpt["scheduler"])
    trainer.step = int(ckpt["step"])
    # the schedule is the current run's (rebuilt from its num_steps), at the
    # restored position, as the JAX package rebuilds tx and keeps opt_state
    lr = trainer.schedule(trainer.scheduler.last_epoch)
    for group in trainer.optimizer.param_groups:
        group["lr"] = lr
    trainer.scheduler._last_lr = [lr] * len(trainer.optimizer.param_groups)


def load_checkpoint(path: str, target: Any) -> Any:
    """Restore ``path`` into ``target`` (a ``Trainer`` with state, or a
    ``Simulator``) in place and return it."""
    _restore(_read(path), target)
    return target


def load_checkpoint_with_metadata(path: str, target: Any) -> Tuple[Any, dict]:
    """``(target, metadata)`` from one read of the file: the embedded
    metadata, else the sidecar's, else ``{}``."""
    ckpt = _read(path)
    _restore(ckpt, target)
    metadata = ckpt.get("metadata")
    return target, (metadata if metadata is not None else _sidecar(path))


def load_metadata(path: str, prefer_sidecar: bool = False) -> dict:
    """The checkpoint's metadata. ``prefer_sidecar`` reads the
    ``.meta.json`` sidecar without loading the state file (for advisory
    reads, such as a W&B run id); otherwise the embedded copy, committed
    with the state, wins, and the sidecar serves files without one."""
    if prefer_sidecar and os.path.exists(path + ".meta.json"):
        return _sidecar(path)
    if os.path.exists(path) and not os.path.isdir(path) and is_torch_checkpoint(path):
        metadata = torch.load(path, map_location="cpu", weights_only=True).get("metadata")
        if metadata is not None:
            return metadata
    return _sidecar(path)

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

The backends keep the JAX package's names: ``"torch"`` (the port's
default, the file above; JAX's is ``"msgpack"``) and the directory backends
``"orbax"`` and ``"orbax-async"``, so configs and CLIs carry over. In the
port those write the same dict as a ``torch.distributed.checkpoint`` (DCP)
directory in one process (no process group: ``no_dist``), staged into
``path + ".next"`` and swapped into place (``_swap_into_place``), so a crash
never leaves the live checkpoint half written. ``"orbax-async"`` returns as
soon as DCP has staged the state in host memory and writes in the
background; ``wait_for_async_saves`` (which ``load_checkpoint`` and the end
of ``Trainer.fit`` call) waits for every pending save and swaps it in. A
stage that finished but was not swapped, or a live directory renamed to
``.old`` by a crash between the two renames, is found by
``_resolve_orbax_dir``. The metadata rides inside the directory and in the
same ``.meta.json`` sidecar.

``load_checkpoint`` restores a port file or directory whole into a
``Trainer`` (weights, normalizers, optimizer, schedule position, step) or
its weights and normalizers into a ``Simulator``. A plain reference file
(the JAX package's ``export_reference_checkpoint``) restores weights and
normalizers and leaves the optimizer fresh, as the JAX package does with
one. The JAX package's msgpack files and orbax directories cross over
through ``export_reference_checkpoint``: the port reads neither format (a
port directory is told from an orbax one by DCP's ``.metadata`` file).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from graphphysics_torch.models.simulator import Simulator
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint

BACKENDS = ("torch", "orbax", "orbax-async")
DIRECTORY_BACKENDS = ("orbax", "orbax-async")
_DCP_METADATA = ".metadata"  # DCP writes it last: a directory with it is complete
_NORMALIZERS = ("_output_normalizer", "_node_normalizer", "_edge_normalizer")
# in-flight "orbax-async" saves: (future, staged directory, final path,
# metadata), swapped in by wait_for_async_saves; module-level as the JAX
# package's, since saves from any Trainer of the process share the disk
_PENDING: List[tuple] = []
# the normalizer constants of the reference format (core/normalizer.py)
_MAX_ACCUMULATIONS = 10**5
_STD_EPSILON = 1e-8


def _cpu(obj: Any) -> Any:
    """A copy on the CPU: a save in the background must not see the
    training that goes on (``.cpu()`` alone would return a CPU tensor
    itself)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
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


def require_backend(backend: str) -> None:
    """Raise unless ``backend`` is one of ``BACKENDS`` (the Trainer checks
    at start-up, not after the first epoch)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}; expected one of {BACKENDS}")


def _write_sidecar(path: str, metadata: Optional[dict]) -> None:
    if metadata is None:
        return
    # advisory: the embedded copy wins, the sidecar may lag one save behind
    # after a crash between the two replaces
    tmp_meta = path + ".meta.json.tmp"
    with open(tmp_meta, "w") as f:
        json.dump(metadata, f)
    os.replace(tmp_meta, path + ".meta.json")


def _swap_into_place(staged: str, final: str) -> None:
    """Promote a complete staged directory to the live path. The one
    window where ``final`` is missing leaves a complete ``staged`` or
    ``.old`` directory behind, which ``_resolve_orbax_dir`` finds."""
    old = final + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(staged, final)
    if os.path.exists(old):
        shutil.rmtree(old)


def wait_for_async_saves() -> None:
    """Wait for every in-flight ``orbax-async`` save, swap each staged
    directory live and write its sidecar (``Trainer.fit`` calls this when
    it ends, ``load_checkpoint`` before it reads)."""
    while _PENDING:
        future, staged, final, metadata = _PENDING.pop(0)
        future.result()
        _swap_into_place(staged, final)
        _write_sidecar(final, metadata)


@contextlib.contextmanager
def _one_process():
    """DCP in this one process: its calls warn that no process group is
    initialized, which is what ``no_dist`` asks for."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _save_directory(ckpt: Dict[str, Any], path: str, metadata: Optional[dict], backend: str) -> None:
    import torch.distributed.checkpoint as dcp

    final = os.path.abspath(path)
    staged = final + ".next"
    if backend == "orbax-async":
        wait_for_async_saves()  # the previous save owns the stage until it is swapped in
    if os.path.exists(staged):
        shutil.rmtree(staged)  # a stale stage of a crashed run
    os.makedirs(os.path.dirname(final), exist_ok=True)
    if backend == "orbax-async":
        with _one_process():
            future = dcp.async_save(ckpt, checkpoint_id=staged, no_dist=True)
        _PENDING.append((future, staged, final, metadata))
        return
    with _one_process():
        dcp.save(ckpt, checkpoint_id=staged, no_dist=True)
    _swap_into_place(staged, final)
    _write_sidecar(final, metadata)


def save_checkpoint(path: str, target: Any, metadata: Optional[dict] = None,
                    backend: str = "torch") -> None:
    """Write the checkpoint of ``target`` (a ``Trainer`` or a
    ``Simulator``) to ``path`` atomically, with ``metadata`` inside it and
    in ``path + ".meta.json"``: one ``torch.save`` file (``"torch"``) or a
    DCP directory (``"orbax"``; ``"orbax-async"`` writes in the background,
    see ``wait_for_async_saves``)."""
    require_backend(backend)
    ckpt = _checkpoint_dict(target, metadata)
    if backend in DIRECTORY_BACKENDS:
        _save_directory(ckpt, path, metadata, backend)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    _write_sidecar(path, metadata)


def is_torch_checkpoint(path: str) -> bool:
    """True if ``path`` is a ``torch.save`` file: a zip archive, or a pickle
    stream (the legacy format)."""
    with open(path, "rb") as f:
        magic = f.read(2)
    return magic == b"PK" or (len(magic) == 2 and magic[0] == 0x80 and magic[1] < 0x10)


def _is_port_directory(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _DCP_METADATA))


def _resolve_orbax_dir(path: str) -> Optional[str]:
    """The newest complete checkpoint directory of ``path``, or None if
    there is none: a ``.next`` stage that DCP finished (it is newer than
    the live one; without its ``.metadata`` it is a crashed partial and is
    passed over), then the live path, then a ``.old`` left by a crash
    between the two renames of the swap."""
    for cand in (path + ".next", path, path + ".old"):
        if os.path.isdir(cand) and (_is_port_directory(cand) or cand != path + ".next"):
            return cand
    return None


def _read_directory(directory: str) -> Dict[str, Any]:
    """The checkpoint dict of a port directory, read without a template
    through DCP's ``format_utils.dcp_to_torch_save`` (into a temporary
    file): the optimizer's per-parameter state comes back keyed by the
    parameter's index as a string, and is keyed by the int again."""
    import tempfile

    from torch.distributed.checkpoint.format_utils import dcp_to_torch_save

    with tempfile.TemporaryDirectory(prefix="grph_torch_dcp_") as tmp:
        with _one_process():
            dcp_to_torch_save(directory, os.path.join(tmp, "state.pt"))
        ckpt = torch.load(os.path.join(tmp, "state.pt"), map_location="cpu", weights_only=True)
    if ckpt.get("optimizer") is not None:
        state = ckpt["optimizer"].get("state", {})
        ckpt["optimizer"]["state"] = {int(k): v for k, v in state.items()}
    return ckpt


def _read(path: str) -> Dict[str, Any]:
    wait_for_async_saves()  # an in-flight save may be this path
    directory = _resolve_orbax_dir(path)
    if directory is not None:
        if not _is_port_directory(directory):
            raise ValueError(
                f"{directory} is a checkpoint directory of the JAX package (orbax), not a "
                f"torch.distributed.checkpoint one; write a reference file from JAX with "
                f"graphphysics_tpu.utils.torch_import.export_reference_checkpoint"
            )
        return _read_directory(directory)
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
    ``.meta.json`` sidecar without loading the state (for advisory reads,
    such as a W&B run id); otherwise the embedded copy, committed with the
    state, wins, and the sidecar serves checkpoints without one."""
    wait_for_async_saves()
    if prefer_sidecar and os.path.exists(path + ".meta.json"):
        return _sidecar(path)
    directory = _resolve_orbax_dir(path)
    if directory is not None and _is_port_directory(directory):
        metadata = _read_directory(directory).get("metadata")
    elif os.path.isfile(path) and is_torch_checkpoint(path):
        metadata = torch.load(path, map_location="cpu", weights_only=True).get("metadata")
    else:
        metadata = None
    return metadata if metadata is not None else _sidecar(path)

"""Bitwise determinism checks (counterpart of
``graphphysics_tpu/utils/determinism.py``).

- ``check_item_determinism``: a dataset item rebuilt twice must be the same
  bits (the contract exact resume relies on).
- ``check_step_determinism``: a train step replayed from cloned state and
  batch must give the same bits in every parameter, optimizer slot and
  output. ``trainer_state`` and ``trainer_step`` make a ``Trainer`` such a
  step.

Both report rather than assert: the leaves that differ, by path, with each
one's largest absolute difference. They make nothing equal. On the card
the float32 transformer step is expected to differ: the fused attention's
float32 backward sums dk and dv with atomics, in an order that changes from
run to run (``csrc/csr_attention_bwd.cu``); its bf16 backward has no
atomics and replays bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested structure of dicts, lists, tuples and
    dataclasses (a ``Graph``); tensors, arrays, numbers, strings and None
    are leaves."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name), f"{path}.{f.name}")]
    return [(path, tree)]


def _structure(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, [_structure(v) for v in tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree).__name__, {f.name: _structure(getattr(tree, f.name))
                                     for f in dataclasses.fields(tree)}
    return None


def _clone(tree: Any) -> Any:
    """A deep copy with every tensor on fresh memory of its own device."""
    return copy.deepcopy(tree, memo={id(t): t.detach().clone() for _, t in _leaves(tree)
                                     if isinstance(t, torch.Tensor)})


def _array(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        # bf16 has no numpy type: its bits as int16
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return leaf


def _compare(tree_a: Any, tree_b: Any) -> Tuple[List[str], Dict[str, float]]:
    """The paths of the leaves that differ bitwise (a structure that differs
    is one entry), and each differing array's largest absolute difference."""
    if _structure(tree_a) != _structure(tree_b):
        return [f"tree structure differs: {_structure(tree_a)} != {_structure(tree_b)}"], {}
    mismatches, diffs = [], {}
    for (path, a), (_, b) in zip(_leaves(tree_a), _leaves(tree_b)):
        arr_a, arr_b = _array(a), _array(b)
        if isinstance(arr_a, np.ndarray) or isinstance(arr_b, np.ndarray):
            arr_a, arr_b = np.asarray(arr_a), np.asarray(arr_b)
            if arr_a.shape != arr_b.shape or arr_a.dtype != arr_b.dtype:
                mismatches.append(f"{path} (shape/dtype)")
            elif arr_a.tobytes() != arr_b.tobytes():
                mismatches.append(path)
                if isinstance(a, torch.Tensor) and a.is_floating_point():
                    diffs[path] = float((a.detach().double() - b.detach().double()).abs().max())
                elif arr_a.dtype.kind in "fiu":
                    diffs[path] = float(np.abs(arr_a.astype(np.float64) - arr_b).max())
        elif arr_a != arr_b:
            mismatches.append(path)
    return mismatches, diffs


def check_item_determinism(dataset, index: int = 0) -> Dict[str, Any]:
    """Build item ``index`` of ``dataset`` twice; report the leaves that
    differ bitwise."""
    mismatches, diffs = _compare(dataset[index], dataset[index])
    return {"deterministic": not mismatches, "mismatches": mismatches, "max_abs_diff": diffs}


def check_step_determinism(step_fn: Callable, state: Any, batch: Any, runs: int = 2) -> Dict[str, Any]:
    """Run ``step_fn(state, batch)`` ``runs`` times, each from fresh clones
    of ``state`` and ``batch`` (so a step may update them in place), and
    report every leaf of its result (the new state and its outputs) that
    differs bitwise from the first run's, with ``compared`` leaves in all."""
    outs = [step_fn(_clone(state), _clone(batch)) for _ in range(runs)]
    mismatches: List[str] = []
    diffs: Dict[str, float] = {}
    for other in outs[1:]:
        found, found_diffs = _compare(outs[0], other)
        mismatches.extend(m for m in found if m not in mismatches)
        for path, d in found_diffs.items():
            diffs[path] = max(d, diffs.get(path, 0.0))
    return {"deterministic": not mismatches, "mismatches": mismatches, "max_abs_diff": diffs,
            "compared": len(_leaves(outs[0]))}


def trainer_state(trainer) -> Dict[str, Any]:
    """A snapshot of a ``Trainer``'s state (clones): its Simulator's weights
    and normalizer statistics, the optimizer's slots, the schedule's
    position and the step."""
    return _clone({"model": trainer.sim.state_dict(), "optimizer": trainer.optimizer.state_dict(),
                   "scheduler": trainer.scheduler.state_dict(), "step": trainer.step})


def trainer_step(trainer) -> Callable:
    """``step(state, batch) -> (state, loss)`` of a ``Trainer`` with state:
    ``trainer_state`` loaded into it, one ``train_step`` on ``batch``, the
    new ``trainer_state`` and the loss (for ``check_step_determinism``)."""

    def step(state, batch):
        trainer.sim.load_state_dict(state["model"])
        trainer.optimizer.load_state_dict(state["optimizer"])
        trainer.scheduler.load_state_dict(state["scheduler"])
        trainer.step = state["step"]
        loss = trainer.train_step(batch)
        return trainer_state(trainer), loss.detach().clone()

    return step

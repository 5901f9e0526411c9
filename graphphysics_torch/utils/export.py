"""Serving artifacts through ``torch.export`` (counterpart of
``graphphysics_tpu/utils/export.py``).

The exported unit is the one-frame eval forward (normalize, model,
denormalize: the predicted next fields) or the whole autoregressive rollout
of a trajectory, with the trained weights and the normalizer statistics
baked into the program. An artifact is the bytes of ``torch.export.save``:
any process that imports this package (which registers the kernels' ops,
``torch.ops.graphphysics_torch.*``) loads and runs it without the model's
config, classes or checkpoint code. On CUDA tensors the loaded program
launches the hand-written kernels, as the live model does; on CPU tensors
their plain versions.

The artifact takes the padded ``Graph``'s array fields, in field order
(those present when it was exported; fields that are not arrays, such as
``ell_degree``, are baked in), and returns the denormalized prediction
``[N, output_size]``. Shapes are static, because padding makes them so: one
artifact serves one padded shape (one per size bucket). A GMM head
(``num_mixture_components`` > 0) samples: its artifact takes the draws of
``models.gmm.draw_gmm`` as two more tensors, the counterpart of the JAX
artifact's PRNG key, since a ``torch.Generator`` cannot cross
``torch.export``; the loaded step makes them from the caller's generator,
so it samples what the live model samples from the same generator.

``export_rollout`` unrolls the T frames of ``training.rollout``: one
artifact serves one (T, padded shape) pair, as in JAX. The partitioned eval
step (JAX ``export_partitioned_eval_step``) needs the halo exchange as
traceable collectives and is not ported (ROADMAP.md section 1, item 13).

The program is traced on the device the simulator lives on, with the
example's tensors there; it runs on that device.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

import graphphysics_torch.ops  # noqa: F401  (registers the kernels' ops for load)
from graphphysics_torch.core.graph import META_FIELDS, Graph
from graphphysics_torch.models.gmm import draw_gmm
from graphphysics_torch.training.rollout import rollout_frames

# the artifact's description, saved beside the program
ARTIFACT_FILE = "graphphysics_torch.json"


def _array_fields(graph: Graph) -> List[str]:
    return [f.name for f in dataclasses.fields(Graph)
            if f.name not in META_FIELDS and getattr(graph, f.name) is not None]


def _graph_of(names, meta, arrays) -> Graph:
    fields = {f.name: None for f in dataclasses.fields(Graph) if f.name not in META_FIELDS}
    fields.update(zip(names, arrays))
    return Graph(**fields, **meta)


class _Program(nn.Module):
    """``run(sim, graph, draws)`` on the Graph of the artifact's tensors:
    the array fields ``names`` in order, then the draws where ``draws``."""

    def __init__(self, sim, names, meta, draws: bool, run: Callable):
        super().__init__()
        self.sim, self.names, self.meta, self.draws, self.run = sim, names, meta, draws, run

    def forward(self, *arrays):
        n = len(self.names)
        graph = _graph_of(self.names, self.meta, arrays[:n])
        return self.run(self.sim, graph, tuple(arrays[n:]) if self.draws else None)


def _eval_step(sim, graph, draws):
    return sim(graph, is_training=False, draws=draws)[2]


def _rollout(sim, frames, draws, previous):
    return rollout_frames(sim, frames, draws=draws, **previous)


def _export(module: nn.Module, args: tuple, description: dict) -> bytes:
    was_training = module.sim.training
    module.sim.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(module, args)
    finally:
        module.sim.train(was_training)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={ARTIFACT_FILE: json.dumps(description)})
    return buf.getvalue()


def _example_draws(sim, shape_nodes: Tuple[int, ...], device) -> tuple:
    """Zero draws of ``draw_gmm``'s shapes (``shape_nodes`` + ``[K]`` and
    ``[d]``) for the trace."""
    return (torch.zeros((*shape_nodes, sim.model.K), device=device),
            torch.zeros((*shape_nodes, sim.model.d), device=device))


def export_eval_step(sim, example_graph: Graph) -> bytes:
    """The eval forward of ``sim`` on graphs shaped as ``example_graph`` (a
    padded Graph of tensors on the simulator's device), as the bytes of a
    ``torch.export`` artifact. A GMM head's artifact takes the draws."""
    names = _array_fields(example_graph)
    draws = sim.model.K > 0
    args = tuple(getattr(example_graph, n) for n in names)
    if draws:
        args += _example_draws(sim, (example_graph.num_nodes,), args[0].device)
    description = {"kind": "eval_step", "fields": names, "meta": example_graph.meta(),
                   "draws": draws, "K": sim.model.K, "d": sim.model.d}
    return _export(_Program(sim, names, example_graph.meta(), draws, _eval_step), args, description)


def _load(blob: bytes):
    description = {ARTIFACT_FILE: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=description)
    return program.module(), json.loads(description[ARTIFACT_FILE])


def _arrays(graph: Graph, description: dict) -> list:
    names = _array_fields(graph)
    if names != description["fields"] or graph.meta() != description["meta"]:
        raise ValueError(f"the graph's fields {names} and {graph.meta()} are not the exported "
                         f"ones {description['fields']} and {description['meta']}")
    return [getattr(graph, n) for n in names]


def _draws(description: dict, n: int, generator, device, frames: Optional[int] = None) -> list:
    """The draws a GMM artifact takes, from ``generator``: one
    ``draw_gmm`` of ``n`` nodes, or with ``frames`` one a frame, stacked."""
    if not description["draws"]:
        return []
    if generator is None:
        raise ValueError("this artifact samples a GMM head: pass generator=")
    pairs = [draw_gmm(n, description["K"], description["d"], generator) for _ in range(frames or 1)]
    if frames is None:
        return [t.to(device) for t in pairs[0]]
    return [torch.stack(ts).to(device) for ts in zip(*pairs)]


def load_eval_step(blob: bytes) -> Callable:
    """An ``export_eval_step`` artifact as ``step(graph, generator=None) ->
    predicted``, run under ``torch.inference_mode`` (as ``rollout`` runs the
    live model). The graph must have the exported fields and shapes; a GMM
    artifact draws from ``generator`` (on the generator's device, as the
    live model's eval does) and needs one."""
    program, description = _load(blob)

    def step(graph: Graph, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        arrays = _arrays(graph, description)
        with torch.inference_mode():
            return program(*arrays, *_draws(description, graph.num_nodes, generator,
                                            arrays[0].device))

    step.description = description
    return step


def save_eval_step(path: str, sim, example_graph: Graph) -> str:
    """Export the eval step and write the artifact to ``path``."""
    blob = export_eval_step(sim, example_graph)
    with open(path, "wb") as fp:
        fp.write(blob)
    return path


def load_eval_step_file(path: str) -> Callable:
    with open(path, "rb") as fp:
        return load_eval_step(fp.read())


def export_rollout(
    sim,
    example_frames: Graph,
    use_previous_data: bool = False,
    previous_data_start: Optional[int] = None,
    previous_data_end: Optional[int] = None,
) -> bytes:
    """The whole autoregressive rollout of ``training.rollout`` over stacked
    frames shaped as ``example_frames`` (``[T, ...]`` tensors on the
    simulator's device), the T frames unrolled, as the bytes of a
    ``torch.export`` artifact that returns ``(predictions, targets)``, each
    ``[T, N, d]``. A GMM head's artifact takes ``[T, ...]`` draws."""
    names = _array_fields(example_frames)
    draws = sim.model.K > 0
    args = tuple(getattr(example_frames, n) for n in names)
    if draws:
        args += _example_draws(sim, tuple(example_frames.x.shape[:2]), args[0].device)
    previous = {"use_previous_data": use_previous_data, "previous_data_start": previous_data_start,
                "previous_data_end": previous_data_end}
    description = {"kind": "rollout", "fields": names, "meta": example_frames.meta(),
                   "draws": draws, "K": sim.model.K, "d": sim.model.d, **previous}
    run = functools.partial(_rollout, previous=previous)
    return _export(_Program(sim, names, example_frames.meta(), draws, run), args, description)


def load_rollout(blob: bytes) -> Callable:
    """An ``export_rollout`` artifact as ``run(frames, generator=None) ->
    (predictions, targets)`` under ``torch.inference_mode``; a GMM artifact
    draws each frame's sample from ``generator`` in frame order, as
    ``training.rollout`` does."""
    program, description = _load(blob)

    def run(frames: Graph, generator: Optional[torch.Generator] = None):
        arrays = _arrays(frames, description)
        with torch.inference_mode():
            return program(*arrays, *_draws(description, frames.num_nodes, generator,
                                            arrays[0].device, frames=frames.x.shape[0]))

    run.description = description
    return run

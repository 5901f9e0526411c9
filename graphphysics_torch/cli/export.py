"""Export CLI (counterpart of ``graphphysics_tpu/cli/export.py``): a trained
checkpoint to ``torch.export`` serving artifacts, the one-frame eval step
and, with ``--rollout``, the whole rollout of a trajectory, the trained
weights and normalizer statistics baked in (``utils/export.py``):

    python -m graphphysics_torch.cli export --training_parameters_path=cfg.json \\
        --model_path checkpoints/state.pt --output_dir exported [--rollout] [--device cpu]

The artifacts are traced on ``--device`` (``cuda`` unless named) with the
padded shape of the config's first validation item, and run there: one
artifact per padded shape (and trajectory length). Load them with
``utils.export.load_eval_step_file`` and ``load_rollout``. The JAX CLI's
``--platforms`` has no counterpart (an artifact runs on the device it was
traced on).

``--graph_partition P`` also writes ``eval_step_p{P}.pt2``, the
edge-partitioned eval step (``utils.export.export_partitioned_eval_step``)
of that item cut into ``P`` parts as the Trainer's defaults cut it (halo
mode; the split-edge layout for a transformer; budgets from a trial cut
with the default headroom). One process traces it; it serves a group of
``P`` ranks, each loading it with ``load_partitioned_eval_step`` and
calling it on its part.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from graphphysics_torch.cli.train import previous_data_options
from graphphysics_torch.external import EXTERNAL_FEATURES


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export serving artifacts from a checkpoint")
    p.add_argument("--training_parameters_path", required=True)
    p.add_argument("--model_path", required=True)
    p.add_argument("--output_dir", default="exported")
    p.add_argument("--use_previous_data", action="store_true")
    p.add_argument("--previous_data_start", type=int, default=4)
    p.add_argument("--previous_data_end", type=int, default=7)
    p.add_argument("--no_edge_feature", action="store_true")
    p.add_argument("--external_features", default=None, choices=[None, *EXTERNAL_FEATURES],
                   help="dataset-specific node-feature hook (graphphysics_torch/external)")
    p.add_argument("--rollout", action="store_true",
                   help="also export the whole rollout of validation trajectory 0 (one artifact "
                        "per trajectory length)")
    p.add_argument("--graph_partition", type=int, default=0,
                   help="also export the eval step edge-partitioned into this many parts")
    p.add_argument("--device", default="cuda", help="torch device (cuda unless named)")
    return p


def partition_example(sim, example, parts: int):
    """The host Graph ``example`` cut into ``parts``, stacked ``[P, ...]``,
    as ``Trainer(graph_partition=parts)`` cuts it by default: halo mode,
    the split-edge layout for a transformer, budgets from a trial cut with
    the default headroom."""
    from graphphysics_torch.models.processors import EncodeTransformDecode
    from graphphysics_torch.parallel.graph_partition import partition_graph_halo_np
    from graphphysics_torch.training.trainer import DEFAULT_EDGE_HEADROOM, partition_budgets

    split = isinstance(sim.model, EncodeTransformDecode)
    eb, hb = partition_budgets(example, parts, True, split, DEFAULT_EDGE_HEADROOM)
    return partition_graph_halo_np(example, parts, edge_budget_local=eb, halo_budget=hb,
                                   split_local=split)


def export_partitioned(sim, example, parts: int) -> bytes:
    """The partitioned eval step of ``sim`` on ``example``'s parts
    (``partition_example``), traced on part 0."""
    from graphphysics_torch.parallel.graph_partition import part_of
    from graphphysics_torch.utils.export import export_partitioned_eval_step

    device = next(sim.parameters()).device
    stacked = partition_example(sim, example, parts)
    return export_partitioned_eval_step(sim, part_of(stacked, 0).to(device), parts)


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    with open(args.training_parameters_path) as fp:
        parameters = json.load(fp)

    from graphphysics_torch.core.graph import stack_graphs
    from graphphysics_torch.training.checkpoint import load_checkpoint
    from graphphysics_torch.training.parse_parameters import get_dataset, get_preprocessing
    from graphphysics_torch.training.trainer import Trainer
    from graphphysics_torch.utils.export import export_eval_step, export_rollout

    use_edge_feature = not args.no_edge_feature
    ds = get_dataset(
        parameters,
        get_preprocessing(parameters, use_edge_feature=use_edge_feature, remove_noise=True,
                          extra_node_features=EXTERNAL_FEATURES.get(args.external_features)),
        use_edge_feature=use_edge_feature, use_previous_data=args.use_previous_data,
        switch_to_val=True,
    )
    previous = previous_data_options(args)
    trainer = Trainer(parameters, metrics_path=None, rollout_dir=None, device=args.device, **previous)
    trainer.init_state(num_steps=1)
    load_checkpoint(args.model_path, trainer.sim)
    example = ds[0].to(trainer.device)

    os.makedirs(args.output_dir, exist_ok=True)
    eval_path = os.path.join(args.output_dir, "eval_step.pt2")
    blob = export_eval_step(trainer.sim, example)
    with open(eval_path, "wb") as fp:
        fp.write(blob)
    print(f"[export] eval step -> {eval_path} ({len(blob)} bytes, {example.num_nodes} nodes / "
          f"{example.num_edges} edges)")

    if args.graph_partition:
        part_path = os.path.join(args.output_dir, f"eval_step_p{args.graph_partition}.pt2")
        blob = export_partitioned(trainer.sim, ds[0], args.graph_partition)
        with open(part_path, "wb") as fp:
            fp.write(blob)
        print(f"[export] partitioned eval (P={args.graph_partition}) -> {part_path} "
              f"({len(blob)} bytes)")

    if args.rollout:
        frames = stack_graphs([ds[i] for i in ds.trajectory_indices(0)]).to(trainer.device)
        roll_path = os.path.join(args.output_dir, "rollout.pt2")
        blob = export_rollout(trainer.sim, frames, **previous)
        with open(roll_path, "wb") as fp:
            fp.write(blob)
        print(f"[export] rollout -> {roll_path} ({len(blob)} bytes, T={frames.x.shape[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

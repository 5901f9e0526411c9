"""Training CLI (counterpart of ``graphphysics_tpu/cli/train.py``):

    python -m graphphysics_torch.cli.train --training_parameters_path=cfg.json \\
        --num_epochs 10 --batch_size 2 --init_lr 1e-3 --warmup 1000 [--device cpu]

The JAX CLI's JSON config and flag names, plus ``--device`` (``cuda`` unless
named). CSV metrics are always written, W&B only with ``--project_name`` and
wandb installed. ``--gradient_accumulation`` makes each batch of
``batch_size`` items one optimizer step over that many microbatches (the
loader stacks them). The config's ``dataset.num_buckets`` and
``dataset.edge_layout`` (``"ell"`` for the ELL layout) reach the datasets.
``--graph_partition P`` trains edge-partitioned over P ranks, and
``--data_parallel`` data-parallel over R ranks (``--num_devices``: under
``torchrun`` its ``WORLD_SIZE``, else one rank a card, as JAX takes every
local device; one on the CPU unless named), each building its own rows
of every batch (``parallel.multihost.MultihostGraphLoader``, ``batch_size
/ R`` a rank); both together train the 2-D ``R / P`` x ``P`` layout, one
graph of ``batch_size`` (= R / P) a data row. The command starts the
ranks (``parallel.mesh.launch``; ranks that share a card use gloo), or
under ``torchrun`` joins its ranks; world rank 0 writes the checkpoints
and ``metrics.csv``. ``--checkpoint_backend
orbax|orbax-async`` writes directory checkpoints, ``--profile_dir`` a
``torch.profiler`` trace of ``--profile_num_steps`` steps from
``--profile_start_step``, ``--compilation_cache_dir`` keeps the kernels'
libraries there.
"""

from __future__ import annotations

import argparse
import json
import sys

from graphphysics_torch.dataset import GraphLoader
from graphphysics_torch.external import EXTERNAL_FEATURES
from graphphysics_torch.training.parse_parameters import get_dataset, get_preprocessing
from graphphysics_torch.training.trainer import Trainer
from graphphysics_torch.utils.metrics import WandbLogger


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a graphphysics_torch model")
    p.add_argument("--training_parameters_path", required=True)
    p.add_argument("--project_name", default=None, help="W&B project (optional)")
    p.add_argument("--num_epochs", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--init_lr", type=float, default=0.001)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--warmup", type=int, default=1000)
    p.add_argument("--prefetch_factor", type=int, default=2,
                   help="batches built ahead of the step (by a thread, or per worker)")
    p.add_argument("--num_workers", type=int, default=0,
                   help="worker processes for item building (0 = in-process)")
    p.add_argument("--model_save_name", default="state.pt")
    p.add_argument("--model_path", default=None, help="checkpoint to resume from")
    p.add_argument("--resume_training", action="store_true")
    p.add_argument("--use_previous_data", action="store_true")
    p.add_argument("--previous_data_start", type=int, default=4)
    p.add_argument("--previous_data_end", type=int, default=7)
    p.add_argument("--no_edge_feature", action="store_true")
    p.add_argument("--masking_ratio", type=float, default=None,
                   help="node masking: int((1 - ratio) * N) nodes per item marked exclude_mask")
    p.add_argument("--val_trajectories", type=int, default=None)
    p.add_argument("--checkpoint_dir", default="checkpoints")
    p.add_argument("--metrics_path", default="metrics.csv")
    p.add_argument("--data_parallel", action="store_true",
                   help="data-parallel over --num_devices ranks, each building its own rows")
    p.add_argument("--num_devices", type=int, default=None,
                   help="ranks of --data_parallel (default: torchrun's WORLD_SIZE, else the "
                        "cards, else 1 on the CPU)")
    p.add_argument("--gradient_accumulation", action="store_true",
                   help="one optimizer step per batch of batch_size microbatches, run in "
                        "turn (the activation memory of one microbatch)")
    p.add_argument("--graph_partition", type=int, default=0)
    p.add_argument("--partition_mode", default="halo", choices=["halo", "gather"])
    p.add_argument("--partition_edge_headroom", type=float, default=1.25)
    p.add_argument("--no_partition_budget_growth", action="store_true")
    p.add_argument("--partition_reorder", default=None, choices=["rcm", "bfs", "hilbert", "none"])
    p.add_argument("--no_partition_overlap_attention", action="store_true")
    p.add_argument("--halo_dtype", default=None, choices=["bf16", "f16", "none"])
    p.add_argument("--partitioned_validation", action="store_true")
    p.add_argument("--save_every_n_steps", type=int, default=None,
                   help="also checkpoint mid-epoch every N steps (SIGTERM/SIGINT always "
                        "checkpoint before exit)")
    p.add_argument("--checkpoint_backend", default="torch", choices=["torch", "orbax", "orbax-async"],
                   help="torch: one torch.save file in the reference format; orbax, orbax-async: "
                        "a torch.distributed.checkpoint directory (async: written in the background)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of a few train steps here")
    p.add_argument("--profile_start_step", type=int, default=10)
    p.add_argument("--profile_num_steps", type=int, default=3)
    p.add_argument("--progress", default="auto", choices=["auto", "on", "off"],
                   help="in-place per-epoch progress line (auto: TTY only)")
    p.add_argument("--compilation_cache_dir", default=None,
                   help="build and reuse the CUDA kernels' libraries here")
    p.add_argument("--external_features", default=None, choices=[None, *EXTERNAL_FEATURES],
                   help="dataset-specific node-feature hook (graphphysics_torch/external)")
    p.add_argument("--device", default="cuda", help="torch device (cuda unless named)")
    return p


def previous_data_options(args: argparse.Namespace) -> dict:
    """The Trainer's previous-data options of ``--use_previous_data``,
    ``--previous_data_start`` and ``--previous_data_end``."""
    if not args.use_previous_data:
        return {}
    return {"use_previous_data": True, "previous_data_start": args.previous_data_start,
            "previous_data_end": args.previous_data_end}


def unify_budgets(train_ds, val_ds) -> None:
    """One padded shape for both splits (a val trajectory may be larger
    than every train one): the budgets derive at the first item, then each
    split takes the larger of each budget and ELL degree. Size-bucketed
    datasets are left alone: every trajectory pads to its own bucket, so
    no split outgrows a budget."""
    _ = train_ds[0], val_ds[0]
    if train_ds.num_buckets > 1 or val_ds.num_buckets > 1:
        return
    train_ds.node_budget = val_ds.node_budget = max(train_ds.node_budget, val_ds.node_budget)
    if train_ds.edge_budget or val_ds.edge_budget:
        eb = max(train_ds.edge_budget or 0, val_ds.edge_budget or 0)
        train_ds.edge_budget = val_ds.edge_budget = eb
    if train_ds.ell_degree or val_ds.ell_degree:
        degree = max(train_ds.ell_degree or 0, val_ds.ell_degree or 0)
        train_ds.ell_degree = val_ds.ell_degree = degree


def data_parallel_ranks(args: argparse.Namespace) -> int:
    """The ranks of ``--data_parallel``: ``--num_devices``, else
    ``torchrun``'s ``WORLD_SIZE``, else the cards (1 on the CPU)."""
    import os

    import torch

    if args.num_devices:
        return args.num_devices
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return torch.cuda.device_count() if args.device.startswith("cuda") else 1


def run_partitioned(rank_main, argv, args) -> int:
    """Run ``rank_main(rank, argv)`` on the ranks of the flags
    (``args.graph_partition`` ranks, or with ``--data_parallel`` the ``D x
    P`` layout of ``data_parallel_ranks``): join ``torchrun``'s when it
    started that many, else start them."""
    from graphphysics_torch.parallel import mesh

    parts = args.graph_partition
    layout = None
    world = parts
    if getattr(args, "data_parallel", False):  # the predict CLI starts graph groups only
        world = data_parallel_ranks(args)
        if world % max(parts, 1):
            raise SystemExit(f"--graph_partition {parts} must divide the {world} ranks of "
                             f"--data_parallel")
        layout = (world // max(parts, 1), max(parts, 1))
    if mesh.under_torchrun(world):
        rank = mesh.init_from_env(world, args.device, layout=layout)
        try:
            return rank_main(rank, argv)
        finally:
            import torch.distributed as dist

            dist.destroy_process_group()
    mesh.launch(rank_main, world, args.device, args=(list(argv),), timeout=None, layout=layout)
    return 0


def partition_options(args: argparse.Namespace) -> dict:
    """The Trainer's graph-partition options of the flags."""
    if not args.graph_partition:
        return {}
    return {
        "graph_partition": args.graph_partition,
        "partition_mode": args.partition_mode,
        "partition_edge_headroom": args.partition_edge_headroom,
        "partition_budget_growth": not args.no_partition_budget_growth,
        "partition_reorder": args.partition_reorder,
        "partition_overlap_attention": not args.no_partition_overlap_attention,
        "halo_dtype": args.halo_dtype,
        "partitioned_validation": args.partitioned_validation,
    }


def _rank_main(rank: int, argv) -> int:
    return train(build_argparser().parse_args(argv))


def main(argv=None) -> int:
    parser = build_argparser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    if args.data_parallel and args.gradient_accumulation:
        parser.error("--data_parallel and --gradient_accumulation are separate batch layouts")
    if args.graph_partition or args.data_parallel:
        return run_partitioned(_rank_main, argv, args)
    return train(args)


def enable_cache(args: argparse.Namespace) -> None:
    """``--compilation_cache_dir``: the kernels' libraries built and reused
    there (``utils.compilation_cache``)."""
    if args.compilation_cache_dir:
        from graphphysics_torch.utils.compilation_cache import enable_compilation_cache

        enable_compilation_cache(args.compilation_cache_dir)


def train(args: argparse.Namespace) -> int:
    """The training run of the parsed flags (one rank's, partitioned)."""
    enable_cache(args)
    with open(args.training_parameters_path) as fp:
        parameters = json.load(fp)

    use_edge_feature = not args.no_edge_feature
    extra = EXTERNAL_FEATURES.get(args.external_features)
    train_ds = get_dataset(
        parameters,
        get_preprocessing(parameters, use_edge_feature=use_edge_feature, extra_node_features=extra),
        masking_ratio=args.masking_ratio, use_edge_feature=use_edge_feature,
        use_previous_data=args.use_previous_data,
    )
    val_ds = get_dataset(
        parameters,
        get_preprocessing(parameters, use_edge_feature=use_edge_feature, remove_noise=True,
                          extra_node_features=extra),
        use_edge_feature=use_edge_feature, use_previous_data=args.use_previous_data,
        switch_to_val=True, edge_layout=train_ds.edge_layout,
    )
    unify_budgets(train_ds, val_ds)
    if args.data_parallel:
        from graphphysics_torch.parallel.multihost import MultihostGraphLoader, data_ranks

        rows = data_ranks()[1]  # the data group: the world's ranks over the graph partition
        if args.batch_size % rows:
            raise SystemExit(f"--batch_size {args.batch_size} does not split over {rows} data ranks")
        loader = MultihostGraphLoader(train_ds, per_host_batch=args.batch_size // rows, shuffle=True,
                                      seed=args.seed, num_workers=args.num_workers,
                                      prefetch=args.prefetch_factor)
    else:
        loader = GraphLoader(train_ds, batch_size=args.batch_size, shuffle=True, seed=args.seed,
                             prefetch=args.prefetch_factor, num_workers=args.num_workers,
                             collate="stack" if args.gradient_accumulation else "concat")

    extra_logger = None
    if args.project_name:
        run_id = None
        if args.resume_training and args.model_path:
            from graphphysics_torch.training.checkpoint import load_metadata

            # advisory, before the trainer's own read of the checkpoint
            run_id = load_metadata(args.model_path, prefer_sidecar=True).get("wandb_run_id")
        extra_logger = WandbLogger(
            run_id=run_id,
            project=args.project_name,
            config={
                "architecture": parameters["model"]["type"],
                "#_layers": parameters["model"]["message_passing_num"],
                "#_neurons": parameters["model"]["hidden_size"],
                "#_hops": parameters["dataset"].get("khop", 1),
                "max_lr": args.init_lr,
                "batch_size": args.batch_size,
            },
        )

    trainer = Trainer(
        parameters,
        learning_rate=args.init_lr,
        warmup=args.warmup,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_name=args.model_save_name,
        metrics_path=args.metrics_path,
        seed=args.seed,
        extra_logger=extra_logger,
        save_every_n_steps=args.save_every_n_steps,
        progress={"auto": None, "on": True, "off": False}[args.progress],
        device=args.device,
        gradient_accumulation=args.gradient_accumulation,
        checkpoint_backend=args.checkpoint_backend,
        profile_dir=args.profile_dir,
        profile_start_step=args.profile_start_step,
        profile_num_steps=args.profile_num_steps,
        **previous_data_options(args),
        **partition_options(args),
        **({"data_parallel": True, "num_devices": args.num_devices} if args.data_parallel else {}),
    )
    try:
        trainer.fit(
            loader,
            val_dataset=val_ds,
            num_epochs=args.num_epochs,
            resume_from=args.model_path if args.resume_training else None,
            val_trajectories=args.val_trajectories,
        )
    finally:
        loader.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

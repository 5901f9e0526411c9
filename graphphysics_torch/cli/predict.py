"""Prediction CLI (counterpart of ``graphphysics_tpu/cli/predict.py``): load
a checkpoint, roll out every test trajectory and save each as an XDMF time
series:

    python -m graphphysics_torch.cli.predict --training_parameters_path=cfg.json \\
        --model_path checkpoints/state.pt --save_dir predictions [--device cpu]

The checkpoint is a port file or a reference-format one (the JAX package's
``export_reference_checkpoint``). Flags of features not ported yet exit with
an error naming their ROADMAP item when given anything but their default.
"""

from __future__ import annotations

import argparse
import json
import sys

from graphphysics_torch.cli.train import previous_data_options, refuse_not_ported
from graphphysics_torch.external import EXTERNAL_FEATURES
from graphphysics_torch.training.checkpoint import load_checkpoint
from graphphysics_torch.training.parse_parameters import get_dataset, get_preprocessing
from graphphysics_torch.training.trainer import Trainer


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict with a graphphysics_torch model")
    p.add_argument("--training_parameters_path", required=True)
    p.add_argument("--model_path", required=True)
    p.add_argument("--save_dir", default="predictions")
    p.add_argument("--use_previous_data", action="store_true")
    p.add_argument("--previous_data_start", type=int, default=4)
    p.add_argument("--previous_data_end", type=int, default=7)
    p.add_argument("--no_edge_feature", action="store_true")
    p.add_argument("--max_trajectories", type=int, default=None)
    p.add_argument("--external_features", default=None, choices=[None, *EXTERNAL_FEATURES],
                   help="dataset-specific node-feature hook (graphphysics_torch/external)")
    p.add_argument("--graph_partition", type=int, default=0)
    p.add_argument("--partition_mode", default="halo", choices=["halo", "gather"])
    p.add_argument("--partition_reorder", default=None, choices=["rcm", "bfs", "hilbert", "none"])
    p.add_argument("--compilation_cache_dir", default=None)
    p.add_argument("--device", default="cuda", help="torch device (cuda unless named)")
    return p


NOT_PORTED = (
    ("graph_partition", 0, 14),
    ("partition_mode", "halo", 14),
    ("partition_reorder", None, 14),
    ("compilation_cache_dir", None, 12),
)


def main(argv=None) -> int:
    parser = build_argparser()
    args = parser.parse_args(argv)
    refuse_not_ported(parser, args, NOT_PORTED)
    with open(args.training_parameters_path) as fp:
        parameters = json.load(fp)

    use_edge_feature = not args.no_edge_feature
    ds = get_dataset(
        parameters,
        get_preprocessing(parameters, use_edge_feature=use_edge_feature, remove_noise=True,
                          extra_node_features=EXTERNAL_FEATURES.get(args.external_features)),
        use_edge_feature=use_edge_feature,
        use_previous_data=args.use_previous_data,
        switch_to_val=True,
    )
    trainer = Trainer(parameters, metrics_path=None, rollout_dir=None, device=args.device,
                      **previous_data_options(args))
    trainer.init_state(num_steps=1)
    load_checkpoint(args.model_path, trainer.sim)
    trainer.predict(ds, save_dir=args.save_dir, max_trajectories=args.max_trajectories)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Aneurysm fidelity run of the PyTorch port: train the aneurysm transformer
(``training_config/coarse-aneurysm.json``'s family, 10 x 64, 4 heads; with
``--gmm`` the K = 3 GMM head of ``c-a-gmm.json``) on synthetic tetrahedral
XDMF trajectories and report the held-out rollout RMSE of each epoch:

    python3 chip_fidelity.py [--gmm] [--epochs 30] [--device cuda] [--workdir DIR]

The run is ``benchmarks/fidelity_aneurysm.py`` with its defaults, through
the port: 4 training trajectories (seed 0) and 2 held-out ones (seed 12345)
of 30 frames on ``tet_grid(6)``, the aneurysm features
(``external.build_features``) and previous-frame data fed back in the
rollout (columns 5:8), batches of 2, sender-sorted (CSR) graphs, AdamW at
1e-3 with 200 warm-up steps, the model's weights drawn from seed 42. It
prints the persistence baseline (the velocity frozen at each trajectory's
first frame) and, as its last line, one JSON object with the RMSE of every
epoch.

The trajectories are written as XDMF whose heavy data lies inline in the
XML (``write_inline_xdmf``): it needs no ``h5py``. The same writer gives
``chip_smoke.py`` its aneurysm files. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np

EPOCHS = 30
TRAIN_TRAJECTORIES, VAL_TRAJECTORIES = 4, 2
TRAIN_SEED, VAL_SEED = 0, 12345
STEPS = 30
GRID = 6  # tet_grid resolution: GRID^3 nodes
BLOCKS, HIDDEN, HEADS = 10, 64, 4
BATCH = 2
LEARNING_RATE, WARMUP = 1e-3, 200
PREVIOUS_DATA = (5, 8)  # the acceleration columns of the aneurysm features
VELOCITY = (0, 3)
NODE_TYPE_INDEX = 14

_TOPOLOGY = {"triangle": ("Triangle", 3), "tetra": ("Tetrahedron", 4)}


def _data_item(parent: ET.Element, arr: np.ndarray) -> None:
    """An inline ``DataItem`` of ``arr``: integers in decimal, floats as
    the shortest text that reads back as the same float64."""
    arr = np.asarray(arr)
    integer = np.issubdtype(arr.dtype, np.integer)
    kind = "Int" if integer else "Float"
    item = ET.SubElement(parent, "DataItem", Format="XML",
                         Dimensions=" ".join(str(s) for s in arr.shape),
                         DataType=kind, NumberType=kind, Precision=str(arr.dtype.itemsize))
    values = arr.ravel().tolist() if integer else arr.astype(np.float64).ravel().tolist()
    item.text = " ".join(map(repr, values))


def write_inline_xdmf(filename: str, points: np.ndarray, cells: np.ndarray, cell_type: str,
                      frames: Sequence[Tuple[float, Dict[str, np.ndarray]]]) -> str:
    """A temporal XDMF file with its heavy data inline: one uniform grid
    per ``(time, point data)`` of ``frames``, the geometry (float64 points)
    and topology (int64 cells) written once, on the first grid, as meshio
    does."""
    xdmf = ET.Element("Xdmf", Version="3.0")
    collection = ET.SubElement(ET.SubElement(xdmf, "Domain"), "Grid", Name="TimeSeries",
                               GridType="Collection", CollectionType="Temporal")
    topo_name, per_cell = _TOPOLOGY[cell_type]
    for k, (t, point_data) in enumerate(frames):
        grid = ET.SubElement(collection, "Grid", Name=f"t{t}", GridType="Uniform")
        ET.SubElement(grid, "Time", Value=repr(float(t)))
        if k == 0:
            geom = ET.SubElement(grid, "Geometry",
                                 GeometryType="XY" if points.shape[1] == 2 else "XYZ")
            _data_item(geom, np.asarray(points, np.float64))
            topo = ET.SubElement(grid, "Topology", TopologyType=topo_name,
                                 NumberOfElements=str(len(cells)))
            _data_item(topo, np.asarray(cells, np.int64).reshape(-1, per_cell))
        for name, values in point_data.items():
            values = np.asarray(values)
            vector = values.ndim > 1 and values.shape[-1] > 1
            attr = ET.SubElement(grid, "Attribute", Name=name,
                                 AttributeType="Vector" if vector else "Scalar", Center="Node")
            _data_item(attr, values)
    ET.ElementTree(xdmf).write(filename, xml_declaration=True, encoding="utf-8")
    return filename


def write_aneurysm_inline(dirpath: str, num_traj: int, steps: int, n: int,
                          seed=None) -> Tuple[str, str]:
    """``write_aneurysm_xdmf``'s folder (the same trajectories, file names,
    times and meta) with the heavy data inline; returns
    ``(dirpath, meta_path)``."""
    from graphphysics_torch.utils.synthetic import (
        aneurysm_conditions,
        aneurysm_meta,
        aneurysm_trajectory,
        write_json,
    )

    os.makedirs(dirpath, exist_ok=True)
    for k, (phase0, amp) in enumerate(aneurysm_conditions(num_traj, seed)):
        traj, _ = aneurysm_trajectory(steps, n, phase0=phase0, amp=amp)
        frames = [(0.01 * t, {"Vitesse": traj["Vitesse"][t], "wall_mask": traj["wall_mask"]})
                  for t in range(steps)]
        write_inline_xdmf(os.path.join(dirpath, f"mesh_{k}.xdmf"), traj["mesh_pos"],
                          traj["cells"], "tetra", frames)
    return dirpath, write_json(os.path.join(dirpath, "meta.json"), aneurysm_meta(steps))


def fidelity_param(train_dir: str, meta_path: str, gmm: bool) -> dict:
    """The training config of the run: the aneurysm transformer on
    ``train_dir``, with noise on the velocity and the acceleration scaled
    to the synthetic field's O(1) values."""
    model = {"type": "transformer", "message_passing_num": BLOCKS, "hidden_size": HIDDEN,
             "node_input_size": 14, "edge_input_size": 0, "output_size": 3, "num_heads": HEADS}
    if gmm:
        model.update(num_mixture_components=3, temperature=1)
    return {
        "dataset": {"extension": "xdmf", "xdmf_folder": train_dir, "meta_path": meta_path,
                    "khop": 1, "new_edges_ratio": 0, "edge_layout": "csr"},
        "model": model,
        # x after the hook: [Vitesse(3), wall(1), time(1), accel(3), pos(3),
        # inflow accel mean/min/max(3), node type]
        "index": {"feature_index_start": 0, "feature_index_end": 14, "output_index_start": 0,
                  "output_index_end": 3, "node_type_index": NODE_TYPE_INDEX},
        "transformations": {
            "preprocessing": {"noise": [0.02, 0.02, 0.02, 0.01, 0.01, 0.01],
                              "noise_index_start": [0, 1, 2, 5, 6, 7],
                              "noise_index_end": [1, 2, 3, 6, 7, 8], "masking": 0},
            "world_pos_parameters": {"use": False},
        },
    }


def unify_budgets(train_ds, val_ds) -> None:
    """One padded shape for both splits: each derives its budgets at its
    first item, then both take the larger of each."""
    _ = train_ds[0], val_ds[0]
    train_ds.node_budget = val_ds.node_budget = max(train_ds.node_budget, val_ds.node_budget)
    train_ds.edge_budget = val_ds.edge_budget = max(train_ds.edge_budget, val_ds.edge_budget)


def persistence_rmse(val_ds, field_slice: Tuple[int, int], node_type_col: int) -> float:
    """The rollout RMSE of the field frozen at each trajectory's first frame,
    with the rollout metric's rules: nodes neither NORMAL nor OUTFLOW are
    clamped to the truth (no error), the denominator counts every real
    node."""
    from graphphysics_torch.core.nodetype import NodeType

    lo, hi = field_slice
    se_sum, cnt = 0.0, 0.0
    for tr in range(val_ds.size_dataset):
        frames = [val_ds[i] for i in val_ds.trajectory_indices(tr)]
        f0 = frames[0].x[:, lo:hi]
        valid = frames[0].node_mask.astype(bool)
        nt = frames[0].x[:, node_type_col]
        unclamped = valid & ((nt == float(NodeType.NORMAL)) | (nt == float(NodeType.OUTFLOW)))
        for f in frames:
            se_sum += float(((f0 - f.y[:, : hi - lo]) ** 2)[unclamped].sum())
            cnt += float(valid.sum()) * (hi - lo)
    return float(np.sqrt(se_sum / cnt))


def run(workdir: str, epochs: int = EPOCHS, gmm: bool = False, device: str = "cuda") -> dict:
    """The fidelity run: writes the data under ``workdir``, trains
    ``epochs`` epochs with a validation
    rollout of the held-out split after each, and returns the per-epoch
    training loss and RMSE, the persistence baseline and the seconds."""
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.external import build_features
    from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing

    t0 = time.perf_counter()
    train_dir, meta_path = write_aneurysm_inline(os.path.join(workdir, "data", "train"),
                                                 TRAIN_TRAJECTORIES, STEPS, GRID, seed=TRAIN_SEED)
    val_dir, _ = write_aneurysm_inline(os.path.join(workdir, "data", "held_out"),
                                       VAL_TRAJECTORIES, STEPS, GRID, seed=VAL_SEED)
    write_s = time.perf_counter() - t0
    param = fidelity_param(train_dir, meta_path, gmm)
    val_param = json.loads(json.dumps(param))
    val_param["dataset"]["xdmf_folder"] = val_dir
    train_ds = get_dataset(param, get_preprocessing(param, use_edge_feature=False,
                                                    extra_node_features=build_features),
                           use_edge_feature=False, use_previous_data=True)
    val_ds = get_dataset(val_param, get_preprocessing(val_param, use_edge_feature=False,
                                                      remove_noise=True,
                                                      extra_node_features=build_features),
                         use_edge_feature=False, use_previous_data=True)
    unify_budgets(train_ds, val_ds)
    loader = GraphLoader(train_ds, batch_size=BATCH, shuffle=True)
    trainer = Trainer(param, learning_rate=LEARNING_RATE, warmup=WARMUP, use_previous_data=True,
                      previous_data_start=PREVIOUS_DATA[0], previous_data_end=PREVIOUS_DATA[1],
                      checkpoint_dir=os.path.join(workdir, "ckpt"),
                      metrics_path=os.path.join(workdir, "metrics.csv"), rollout_dir=None,
                      log_every=50, progress=False, device=device)
    baseline = persistence_rmse(val_ds, VELOCITY, NODE_TYPE_INDEX)
    print(f"persistence (frozen-velocity) rollout RMSE: {baseline}", flush=True)
    t0 = time.perf_counter()
    history = trainer.fit(loader, val_dataset=val_ds, num_epochs=epochs)
    fit_s = time.perf_counter() - t0
    return {
        "config": "c-a-gmm (K=3)" if gmm else "coarse-aneurysm",
        "device": str(trainer.device),
        "epochs": epochs,
        "train_trajectories": TRAIN_TRAJECTORIES,
        "held_out_trajectories": VAL_TRAJECTORIES,
        "frames": STEPS,
        "nodes": GRID ** 3,
        "steps_per_epoch": len(loader),
        "train_loss_by_epoch": history["train_loss"],
        "val_all_rollout_rmse_by_epoch": history["val_rmse"],
        "final_val_all_rollout_rmse": history["val_rmse"][-1] if history["val_rmse"] else None,
        "persistence_rmse": baseline,
        "write_s": write_s,
        "fit_s": fit_s,
    }


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--gmm", action="store_true", help="the K = 3 GMM head (c-a-gmm.json)")
    p.add_argument("--device", default="cuda", help="torch device (cuda unless named)")
    p.add_argument("--workdir", default=None, help="where the data and checkpoints go "
                   "(a temporary directory, removed at the end, unless named)")
    args = p.parse_args(argv)
    card = {}
    if args.device == "cuda":
        import subprocess

        import torch

        if not torch.cuda.is_available():
            print("chip_fidelity: torch.cuda.is_available() is false; no result")
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        card = {"device_name": torch.cuda.get_device_name(0),
                "nvidia_smi": smi.stdout.strip().splitlines()[0]}
    if args.workdir is None:
        with tempfile.TemporaryDirectory(prefix="aneurysm_fidelity_") as workdir:
            out = run(workdir, args.epochs, args.gmm, args.device)
    else:
        out = run(args.workdir, args.epochs, args.gmm, args.device)
    print(json.dumps({**out, **card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Fidelity runs of the PyTorch port: train a published configuration's
family on synthetic trajectories and report the held-out rollout RMSE of
each epoch:

    python3 chip_fidelity.py [--config aneurysm|cylinder|panels|plate] [--gmm]
                             [--epochs N] [--device cuda] [--workdir DIR]
                             [--graph_partition P [--halo_dtype bf16]]

Each run is a JAX benchmark script with its defaults, through the port's
``Trainer`` (AdamW at 1e-3 with 200 warm-up steps, batches of 2, the
model's weights drawn from seed 42, training trajectories from seed 0 or
the writer's default and held-out ones from seed 12345):

- ``aneurysm`` (default; ``benchmarks/fidelity_aneurysm.py``): the aneurysm
  transformer (``coarse-aneurysm.json``'s family, 10 x 64, 4 heads; with
  ``--gmm`` the K = 3 GMM head of ``c-a-gmm.json``), 4 training and 2
  held-out tetrahedral trajectories of 30 frames on ``tet_grid(6)``, the
  aneurysm features (``external.build_features``) and previous-frame data
  fed back in the rollout (columns 5:8), sender-sorted (CSR) graphs, 30
  epochs;
- ``cylinder`` (``benchmarks/fidelity_cylinder.py``): EncodeProcessDecode
  15 x 128 (``cylinder.json``'s family), 4 + 2 trajectories of 50 frames on
  a 24 x 16 grid held in memory (``MemoryDataset``), 12 epochs;
- ``panels`` (``benchmarks/fidelity_panels.py``): the panels transformer
  15 x 128, 4 heads, 4 + 2 trajectories of 30 frames on a 24 x 16 grid as
  XDMF, 30 epochs;
- ``plate`` (``benchmarks/fidelity_plate.py``): the plate transformer
  10 x 64, 4 heads (``plate.json``'s family: obstacle displacement inputs,
  world-position targets, world edges at radius 0.08), 6 + 2 press
  trajectories of 40 frames on ``tet_box(12, 12, 4)`` and the punch (594
  nodes) held in memory, 15 epochs (the epoch of its record).

It prints the persistence baseline (the field frozen at each trajectory's
first frame) and, as its last line, one JSON object with the training loss
and the RMSE of every epoch.

``--graph_partition P`` trains edge-partitioned, as the JAX benchmark
scripts' flag does: P ranks (``parallel.mesh.launch``; on one card they
share it over gloo), each with its own copy of the data under
``workdir/rank{r}``, every training batch cut into P parts in halo mode
(the transformer's split-edge layout by default), ``--halo_dtype bf16``
shipping the halo rows in 16 bits; validation rolls the whole graph out
unpartitioned. Rank 0's result is printed.

XDMF trajectories are written with their heavy data inline in the XML
(``write_inline_xdmf``) and the others held in memory: nothing needs
``h5py``. The same writers give ``chip_smoke.py`` its data. Runs on the
card unless ``--device cpu``.
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

CONFIGS = ("aneurysm", "cylinder", "panels", "plate")
# each run's epochs: its benchmark script's default, the plate's record epoch
EPOCHS = {"aneurysm": 30, "cylinder": 12, "panels": 30, "plate": 15}
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
CYLINDER_STEPS, CYLINDER_GRID = 50, (24, 16)
PANELS_STEPS, PANELS_GRID = 30, (24, 16)
PLATE_TRAJECTORIES, PLATE_STEPS, PLATE_GRID, PLATE_RADIUS = 6, 40, (12, 4), 0.08

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


def write_panels_inline(dirpath: str, num_traj: int, steps: int, nx: int, ny: int,
                        seed=None) -> Tuple[str, str]:
    """``write_panels_xdmf``'s folder (the same trajectories, file names,
    times and meta) with the heavy data inline; returns
    ``(dirpath, meta_path)``."""
    from graphphysics_torch.utils.synthetic import (
        panels_conditions,
        panels_meta,
        panels_trajectory,
        write_json,
    )

    os.makedirs(dirpath, exist_ok=True)
    for k, (phase0, amp) in enumerate(panels_conditions(num_traj, seed)):
        traj, _ = panels_trajectory(steps, nx, ny, phase0=phase0, amp=amp)
        frames = [(0.05 * t, {"VitesseCoarse": traj["VitesseCoarse"][t],
                              "NodeTypeCoarse": traj["NodeTypeCoarse"][t, :, 0]})
                  for t in range(steps)]
        write_inline_xdmf(os.path.join(dirpath, f"panel_{k}.xdmf"), traj["mesh_pos"][0],
                          traj["cells"][0], "triangle", frames)
    return dirpath, write_json(os.path.join(dirpath, "meta.json"), panels_meta(steps))


def fidelity_param(train_dir: str, meta_path: str, gmm: bool) -> dict:
    """The training config of the aneurysm run: the aneurysm transformer on
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


def _param(dataset: dict, model: dict, features: int, outputs: int, node_type: int, noise: float,
           noise_end: int, world_pos=None) -> dict:
    return {
        "dataset": {"khop": 1, "new_edges_ratio": 0, **dataset},
        "model": model,
        "index": {"feature_index_start": 0, "feature_index_end": features,
                  "output_index_start": 0, "output_index_end": outputs,
                  "node_type_index": node_type},
        "transformations": {
            "preprocessing": {"noise": noise, "noise_index_start": [0],
                              "noise_index_end": [noise_end], "masking": 0},
            "world_pos_parameters": world_pos or {"use": False},
        },
    }


def cylinder_param(meta_path: str) -> dict:
    """``benchmarks/fidelity_cylinder.py``'s config (``cylinder.json``'s
    schema): EncodeProcessDecode 15 x 128 on the velocity (2) with the
    3 Cartesian + Distance edge features, noise 0.02 on the velocity."""
    model = {"type": "epd", "message_passing_num": 15, "hidden_size": 128,
             "node_input_size": 2, "output_size": 2, "edge_input_size": 3}
    return _param({"extension": "h5", "h5_path": "in memory", "meta_path": meta_path}, model,
                  2, 2, 2, 0.02, 2)


def panels_param(train_dir: str, meta_path: str) -> dict:
    """``benchmarks/fidelity_panels.py``'s config (``panels.json``'s
    schema): the transformer 15 x 128, 4 heads, on (vx, vy), predicting the
    3-component velocity, the node type read at column 3."""
    model = {"type": "transformer", "message_passing_num": 15, "hidden_size": 128,
             "node_input_size": 2, "edge_input_size": 0, "output_size": 3, "num_heads": 4}
    return _param({"extension": "xdmf", "xdmf_folder": train_dir, "meta_path": meta_path}, model,
                  2, 3, 3, 0.02, 2)


def plate_param(meta_path: str, radius: float = PLATE_RADIUS) -> dict:
    """``benchmarks/fidelity_plate.py``'s config (``plate.json``'s schema):
    the transformer 10 x 64, 4 heads, on the world position and the
    obstacles' displacement, predicting the world position, with world edges
    at ``radius`` and noise 0.003 on the world position."""
    model = {"type": "transformer", "message_passing_num": 10, "hidden_size": 64,
             "node_input_size": 6, "edge_input_size": 0, "output_size": 3, "num_heads": 4}
    world = {"use": True, "world_pos_index_start": 0, "world_pos_index_end": 3, "radius": radius}
    return _param({"extension": "h5", "h5_path": "in memory", "meta_path": meta_path}, model,
                  6, 3, 6, 0.003, 3, world_pos=world)


def memory_split(param: dict, trajectories, meta_path: str, val: bool, seed: int = 0):
    """A ``MemoryDataset`` over ``trajectories`` in ``param``'s edge layout,
    with its training preprocessing or (``val``) its validation one."""
    from graphphysics_torch.dataset import MemoryDataset
    from graphphysics_torch.training import edge_layout, get_preprocessing

    edges = param["model"]["edge_input_size"] > 0
    return MemoryDataset(
        trajectories, meta_path,
        preprocessing=get_preprocessing(param, use_edge_feature=edges, remove_noise=val),
        add_edge_features=edges, edge_layout=edge_layout(param),
        node_type_index=param["index"]["node_type_index"], seed=seed,
    )


def setup(workdir: str, config: str, gmm: bool = False) -> dict:
    """The run's data under ``workdir``, its config, its datasets (training
    and held-out, padded alike), the ``Trainer``'s extra options and the
    persistence baseline's field and node-type column."""
    from graphphysics_torch.external import build_features
    from graphphysics_torch.training import get_dataset, get_preprocessing
    from graphphysics_torch.utils import synthetic
    from graphphysics_torch.utils.synthetic import write_json

    data = os.path.join(workdir, "data")
    os.makedirs(data, exist_ok=True)
    out = {"options": {}}
    if config == "aneurysm":
        train_dir, meta_path = write_aneurysm_inline(os.path.join(data, "train"),
                                                     TRAIN_TRAJECTORIES, STEPS, GRID, seed=TRAIN_SEED)
        val_dir, _ = write_aneurysm_inline(os.path.join(data, "held_out"), VAL_TRAJECTORIES, STEPS,
                                           GRID, seed=VAL_SEED)
        param = fidelity_param(train_dir, meta_path, gmm)
        val_param = json.loads(json.dumps(param))
        val_param["dataset"]["xdmf_folder"] = val_dir

        def split(p, val):
            pre = get_preprocessing(p, use_edge_feature=False, remove_noise=val,
                                    extra_node_features=build_features)
            return get_dataset(p, pre, use_edge_feature=False, use_previous_data=True)

        out.update(param=param, train=split(param, False), val=split(val_param, True),
                   field=VELOCITY, node_type=NODE_TYPE_INDEX,
                   options={"use_previous_data": True, "previous_data_start": PREVIOUS_DATA[0],
                            "previous_data_end": PREVIOUS_DATA[1]})
    elif config == "panels":
        nx, ny = PANELS_GRID
        train_dir, meta_path = write_panels_inline(os.path.join(data, "train"), TRAIN_TRAJECTORIES,
                                                   PANELS_STEPS, nx, ny, seed=TRAIN_SEED)
        val_dir, _ = write_panels_inline(os.path.join(data, "held_out"), VAL_TRAJECTORIES,
                                         PANELS_STEPS, nx, ny, seed=VAL_SEED)
        param = panels_param(train_dir, meta_path)
        val_param = json.loads(json.dumps(param))
        val_param["dataset"]["xdmf_folder"] = val_dir

        def split(p, val):
            pre = get_preprocessing(p, use_edge_feature=False, remove_noise=val)
            return get_dataset(p, pre, use_edge_feature=False)

        out.update(param=param, train=split(param, False), val=split(val_param, True),
                   field=(0, 3), node_type=3)
    elif config == "cylinder":
        nx, ny = CYLINDER_GRID
        meta_path = write_json(os.path.join(data, "meta.json"),
                               synthetic.cylinder_meta(CYLINDER_STEPS))
        param = cylinder_param(meta_path)

        def trajectories(n, seed):
            return [synthetic.cylinder_trajectory(CYLINDER_STEPS, nx, ny, phase0=phase0)[0]
                    for phase0 in synthetic.cylinder_conditions(n, seed)]

        # the training split without a seed, as the benchmark writes it
        out.update(param=param,
                   train=memory_split(param, trajectories(TRAIN_TRAJECTORIES, None), meta_path, False),
                   val=memory_split(param, trajectories(VAL_TRAJECTORIES, VAL_SEED), meta_path, True),
                   field=(0, 2), node_type=2)
    elif config == "plate":
        nx, nz = PLATE_GRID
        meta_path = write_json(os.path.join(data, "meta.json"),
                               synthetic.plate_press_meta(PLATE_STEPS))
        param = plate_param(meta_path)

        def trajectories(n, seed):
            return [synthetic.plate_press_trajectory(PLATE_STEPS, nx, nz, *c)[0]
                    for c in synthetic.plate_press_conditions(n, seed)]

        out.update(param=param,
                   train=memory_split(param, trajectories(PLATE_TRAJECTORIES, TRAIN_SEED), meta_path,
                                      False),
                   val=memory_split(param, trajectories(VAL_TRAJECTORIES, VAL_SEED), meta_path, True),
                   field=(0, 3), node_type=6)
    else:
        raise ValueError(f"unknown config {config!r}; expected one of {CONFIGS}")
    unify_budgets(out["train"], out["val"])
    return out


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


def run(workdir: str, epochs: int = None, gmm: bool = False, device: str = "cuda",
        config: str = "aneurysm", graph_partition: int = 0, halo_dtype: str = None) -> dict:
    """The fidelity run of ``config``: writes the data under ``workdir``,
    trains ``epochs`` epochs (the config's own by default) with a
    validation rollout of the held-out split after each, and returns the
    per-epoch training loss and RMSE, the persistence baseline and the
    seconds. ``graph_partition`` P runs it on P ranks (rank 0's result)."""
    if gmm and config != "aneurysm":
        raise ValueError("--gmm is the aneurysm run's c-a-gmm head")
    if graph_partition:
        from graphphysics_torch.parallel.mesh import launch

        return launch(_run_rank, graph_partition, device, timeout=None,
                      args=(workdir, epochs, gmm, device, config, graph_partition, halo_dtype))[0]
    return _run(workdir, epochs, gmm, device, config)


def _run_rank(rank: int, workdir: str, epochs, gmm, device, config, parts, halo_dtype) -> dict:
    if device == "cuda":
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    partition = {"graph_partition": parts, "halo_dtype": halo_dtype}
    return {**_run(os.path.join(workdir, f"rank{rank}"), epochs, gmm, device, config, partition),
            **partition}


def _run(workdir: str, epochs, gmm, device, config, partition=None) -> dict:
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer

    epochs = EPOCHS[config] if epochs is None else epochs
    t0 = time.perf_counter()
    run_setup = setup(workdir, config, gmm)
    write_s = time.perf_counter() - t0
    param, train_ds, val_ds = run_setup["param"], run_setup["train"], run_setup["val"]
    loader = GraphLoader(train_ds, batch_size=BATCH, shuffle=True)
    trainer = Trainer(param, learning_rate=LEARNING_RATE, warmup=WARMUP,
                      checkpoint_dir=os.path.join(workdir, "ckpt"),
                      metrics_path=os.path.join(workdir, "metrics.csv"), rollout_dir=None,
                      log_every=50, progress=False, device=device, **run_setup["options"],
                      **(partition or {}))
    baseline = persistence_rmse(val_ds, run_setup["field"], run_setup["node_type"])
    print(f"{config}: persistence (frozen-field) rollout RMSE: {baseline}", flush=True)
    t0 = time.perf_counter()
    history = trainer.fit(loader, val_dataset=val_ds, num_epochs=epochs)
    fit_s = time.perf_counter() - t0
    model = param["model"]
    return {
        "config": {"aneurysm": "c-a-gmm (K=3)" if gmm else "coarse-aneurysm"}.get(config, config),
        "model": f"{model['type']} {model['message_passing_num']}x{model['hidden_size']}",
        "device": str(trainer.device),
        "epochs": epochs,
        "train_trajectories": train_ds.size_dataset,
        "held_out_trajectories": val_ds.size_dataset,
        "frames": train_ds.trajectory_length,
        "nodes": int(train_ds[0].node_mask.sum()),
        "steps_per_epoch": len(loader),
        "train_loss_by_epoch": history["train_loss"],
        "val_all_rollout_rmse_by_epoch": history["val_rmse"],
        "final_val_all_rollout_rmse": history["val_rmse"][-1] if history["val_rmse"] else None,
        "persistence_rmse": baseline,
        "write_s": write_s,
        "fit_s": fit_s,
        "host_ms_per_step": float(np.mean(trainer.host_ms)) if trainer.host_ms else None,
    }


def main(argv: List[str] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="aneurysm", choices=CONFIGS)
    p.add_argument("--epochs", type=int, default=None,
                   help=f"epochs (default: the config's, {EPOCHS})")
    p.add_argument("--gmm", action="store_true",
                   help="the aneurysm run with the K = 3 GMM head (c-a-gmm.json)")
    p.add_argument("--device", default="cuda", help="torch device (cuda unless named)")
    p.add_argument("--workdir", default=None, help="where the data and checkpoints go "
                   "(a temporary directory, removed at the end, unless named)")
    p.add_argument("--graph_partition", type=int, default=0,
                   help="train edge-partitioned over P ranks (halo mode)")
    p.add_argument("--halo_dtype", default=None, choices=["bf16", "f16"],
                   help="16-bit halo wire (with --graph_partition)")
    args = p.parse_args(argv)
    if args.halo_dtype and not args.graph_partition:
        p.error("--halo_dtype requires --graph_partition")
    if args.gmm and args.config != "aneurysm":
        p.error("--gmm is the aneurysm run's c-a-gmm head")
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
        with tempfile.TemporaryDirectory(prefix=f"{args.config}_fidelity_") as workdir:
            out = run(workdir, args.epochs, args.gmm, args.device, args.config,
                      args.graph_partition, args.halo_dtype)
    else:
        out = run(args.workdir, args.epochs, args.gmm, args.device, args.config,
                  args.graph_partition, args.halo_dtype)
    print(json.dumps({**out, **card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

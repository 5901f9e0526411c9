"""Port parity, the DeformingPlate family (``training_config/plate.json``: the
transformer with obstacle-displacement inputs, world-position targets and
cKDTree world edges) on the JAX package's synthetic press data: the port's
in-memory press and cylinder trajectories against the JAX writers' files;
``MemoryDataset`` against ``H5Dataset``; 10 train steps of a narrow plate
transformer (2 blocks, width 16, 4 heads) through both ``Trainer``s; the
held-out rollout against the JAX ``rollout``; one epoch of ``grph-torch
train`` on ``plate.json`` (with node masking, 2 loader workers and prefetch).
Twins of ``test_dataset.py``'s ``test_plate_world_pipeline`` and
``test_plate_press_dataset``. The JAX side runs the unsorted (COO) layout."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphphysics_tpu.core.graph import stack_graphs as jax_stack_graphs
from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.dataset import H5Dataset as JaxH5Dataset
from graphphysics_tpu.dataset.h5_dataset import load_meta_trajectory as jax_load_meta_trajectory
from graphphysics_tpu.models import simulator as jax_simulator
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training import rollout as jax_rollout_mod
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.synthetic import write_cylinder_h5, write_plate_h5, write_plate_press_h5
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.core import NodeType
from graphphysics_torch.core.graph import stack_graphs
from graphphysics_torch.dataset import (
    GraphLoader,
    H5Dataset,
    MemoryDataset,
    build_preprocessing,
    frame_to_sample,
)
from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing, get_simulator, rollout
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from graphphysics_torch.utils.synthetic import (
    cylinder_conditions,
    cylinder_trajectory,
    plate_press_conditions,
    plate_press_meta,
    plate_press_trajectory,
)
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

ROOT = Path(__file__).resolve().parents[1]
# step losses over 10 steps, as test_torch_port_training.py
STEP_RTOL = 2e-5
ROLLOUT_ATOL = 1e-4
STEPS, NX, NZ = 6, 6, 3  # 5 items a trajectory on tet_box(6, 6, 3) + the punch: 126 nodes
RADIUS = 0.08  # the fidelity run's: world edges at this spacing
WORLD = {"world_pos_index_start": 0, "world_pos_index_end": 3, "node_type_index": 6}


@pytest.fixture(scope="module")
def press(tmp_path_factory):
    """Two training trajectories (seed 0) as ``train.h5`` and two held-out
    ones (seed 12345) as ``test.h5`` beside it."""
    root = tmp_path_factory.mktemp("press_data")
    h5_path, meta_path = write_plate_press_h5(str(root), num_traj=2, steps=STEPS, nx=NX, nz=NZ,
                                              seed=0)
    held = root / "held_out"
    write_plate_press_h5(str(held), num_traj=2, steps=STEPS, nx=NX, nz=NZ, seed=12345)
    shutil.copy(held / "train.h5", root / "test.h5")
    return h5_path, meta_path


def _param(h5_path, meta_path):
    """``training_config/plate.json`` on the press file, cut to 2 blocks of
    width 16, at the fidelity run's world-edge radius."""
    param = json.loads((ROOT / "training_config" / "plate.json").read_text())
    param["dataset"].update(h5_path=h5_path, meta_path=meta_path)
    param["model"].update(message_passing_num=2, hidden_size=16)
    param["transformations"]["world_pos_parameters"]["radius"] = RADIUS
    return param


@pytest.mark.parametrize("seed", [0, 12345])
def test_plate_press_trajectories_match_the_jax_writer(tmp_path, seed):
    """The in-memory trajectories, drawn with ``plate_press_conditions``,
    hold the JAX file's arrays (static fields without the time axis) and
    read as the same samples."""
    h5_path, meta_path = write_plate_press_h5(str(tmp_path), num_traj=3, steps=8, nx=5, nz=3,
                                              seed=seed)
    meta = json.loads(Path(meta_path).read_text())
    assert plate_press_meta(8) == meta
    with h5py.File(h5_path) as f:
        for k, (cx, cy, speed) in enumerate(plate_press_conditions(3, seed)):
            traj, _ = plate_press_trajectory(8, 5, 3, cx, cy, speed)
            theirs = jax_load_meta_trajectory(f, str(k), meta)
            for key, value in traj.items():
                np.testing.assert_array_equal(np.broadcast_to(value, theirs[key].shape), theirs[key])
            for frame in (0, 3, 6):
                a = frame_to_sample(traj, frame, meta, frame_target=frame + 1)
                b = frame_to_sample(theirs, frame, meta, frame_target=frame + 1)
                for field in ("x", "y", "pos", "faces", "tetra"):
                    np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


@pytest.mark.parametrize("seed", [None, 12345])
def test_cylinder_trajectories_match_the_jax_writer(tmp_path, seed):
    h5_path, meta_path = write_cylinder_h5(str(tmp_path), num_traj=3, steps=5, nx=6, ny=4,
                                           seed=seed)
    meta = json.loads(Path(meta_path).read_text())
    with h5py.File(h5_path) as f:
        for k, phase0 in enumerate(cylinder_conditions(3, seed)):
            traj, ours_meta = cylinder_trajectory(5, 6, 4, phase0=phase0)
            assert ours_meta == meta
            theirs = jax_load_meta_trajectory(f, str(k), meta)
            for key in theirs:
                np.testing.assert_array_equal(traj[key], theirs[key])


def test_memory_dataset_matches_the_h5_dataset(press, tmp_path):
    param = _param(*press)
    meta_path = press[1]
    trajs = [plate_press_trajectory(STEPS, NX, NZ, *c)[0] for c in plate_press_conditions(2, 0)]
    common = dict(preprocessing=get_preprocessing(param, use_edge_feature=False),
                  add_edge_features=False, node_type_index=6, edge_layout="csr", masking_ratio=0.2)
    mem = MemoryDataset(trajs, meta_path, **common)
    h5 = H5Dataset(press[0], meta_path, **common)
    assert len(mem) == len(h5) == 2 * (STEPS - 1) and mem.node_counts() == h5.node_counts()
    for i in (0, 4, 7):
        a, b = mem[i], h5[i]
        for f in ("x", "y", "senders", "receivers", "edge_mask", "exclude_mask", "sender_bounds"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_plate_world_pipeline(tmp_path):
    """Twin of the JAX test on ``write_plate_h5``'s file: x is
    ``[world_pos(3), obstacle displacement(3), node type, time]``, the
    obstacles' displacement is their move to the next frame, and the edge
    features are Cartesian + Distance and the world-position pair. The
    padded items equal the JAX ones."""
    h5_path, meta_path = write_plate_h5(str(tmp_path))
    pre = build_preprocessing(world_pos_parameters={**WORLD, "radius": 0.5})
    ds = H5Dataset(h5_path, meta_path, preprocessing=pre, node_type_index=6, edge_headroom=2.0,
                   edge_layout="csr")
    jax_ds = JaxH5Dataset(h5_path=h5_path, meta_path=meta_path, node_type_index=6,
                          edge_headroom=2.0, edge_layout="csr",
                          preprocessing=jax_pp.build_preprocessing(
                              world_pos_parameters={**WORLD, "radius": 0.5}))
    g = ds[0]
    n = int(g.node_mask.sum())
    assert g.x.shape[1] == 8
    nt = g.x[:n, 6]
    assert set(np.unique(nt)) <= {float(NodeType.NORMAL), float(NodeType.HANDLE),
                                  float(NodeType.OBSTACLE)}
    obstacle = nt == float(NodeType.OBSTACLE)
    np.testing.assert_allclose(g.x[:n, 3:6][obstacle], g.y[:n][obstacle] - g.x[:n, 0:3][obstacle],
                               rtol=1e-4, atol=1e-6)
    assert g.edge_attr.shape[1] == 8
    jg = jax_ds[0]
    for f in ("x", "y", "senders", "receivers", "edge_attr", "edge_mask"):
        np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(jg, f)), err_msg=f)


def test_plate_press_dataset(tmp_path):
    """Twin of the JAX test: the HANDLE bottom never moves, the punch
    always descends, the NORMAL plate nodes move only after contact, and
    world edges join the punch to the plate near contact."""
    h5_path, meta_path = write_plate_press_h5(str(tmp_path), num_traj=1, steps=12, nx=8, nz=3,
                                              seed=1)
    pre = build_preprocessing(world_pos_parameters={**WORLD, "radius": 0.08})
    ds = H5Dataset(h5_path, meta_path, preprocessing=pre, node_type_index=6, edge_headroom=2.0)
    early, late = ds[0], ds[9]
    for g, deformed in ((early, False), (late, True)):
        n = int(g.node_mask.sum())
        nt = g.x[:n, 6]
        delta = g.y[:n] - g.x[:n, 0:3]
        assert np.abs(delta[nt == float(NodeType.HANDLE)]).max() == 0.0
        assert np.abs(delta[nt == float(NodeType.OBSTACLE)]).max() > 0
        assert (np.abs(delta[nt == float(NodeType.NORMAL)]).max() > 0) == deformed
    n = int(late.node_mask.sum())
    nt = late.x[:n, 6]
    e = late.edge_mask
    s, r = late.senders[e], late.receivers[e]
    cross = ((nt[s] == float(NodeType.OBSTACLE)) & (nt[r] == float(NodeType.NORMAL))) | (
        (nt[r] == float(NodeType.OBSTACLE)) & (nt[s] == float(NodeType.NORMAL)))
    assert int(cross.sum()) > 0


def _datasets(param, val=False):
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=False, remove_noise=val),
                     use_edge_feature=False, switch_to_val=val)
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=False,
                                                                remove_noise=val),
                                use_edge_feature=False, switch_to_val=val)
    return ds, jax_ds


def test_ten_train_steps_match_the_jax_trainer(press):
    """10 steps (2 epochs of 5 batches of 2 frames) through both
    ``Trainer``s from equal weights and equal, well-conditioned normalizer
    statistics: those JAX accumulates over the first epoch's batches,
    copied to the port. A frame's obstacle-displacement columns are
    constant over its nodes (a rigid punch), so statistics from one batch
    would carry the f32 variance round-off of ROADMAP's open fault; over
    the epoch only the all-zero columns are constant, and both packages
    normalize those to 0."""
    param = _param(*press)
    ds, jax_ds = _datasets(param)
    assert len(ds) == len(jax_ds) == 2 * (STEPS - 1)
    loader = GraphLoader(ds, batch_size=2, shuffle=True, prefetch=0)
    jax_loader = JaxLoader(jax_ds, batch_size=2, shuffle=True, prefetch=0)
    jax_trainer = JaxTrainer(param, learning_rate=1e-3, warmup=3, metrics_path=None,
                             rollout_dir=None)
    jax_trainer.init_state(jax.device_put(jax_loader.peek()), 10)
    trainer = Trainer(param, learning_rate=1e-3, warmup=3, device="cpu")
    trainer.init_state(10)
    state = jax_trainer.state
    variables = {"params": state["params"], "normalizer": state["normalizer"]}
    for jb in jax_loader:
        _, mut = jax_trainer.sim.apply(variables, jax.device_put(jb), mutable=["normalizer"],
                                       method=jax_simulator.Simulator.accumulate_stats)
        variables["normalizer"] = mut["normalizer"]
    state["normalizer"] = variables["normalizer"]
    load_reference_checkpoint(trainer.sim, export_reference_checkpoint(variables))
    losses, jax_losses = [], []
    for epoch in range(2):
        loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        for b, jb in zip(loader, jax_loader):
            np.testing.assert_array_equal(b.x[b.node_mask], np.asarray(jb.x)[np.asarray(jb.node_mask)])
            jax_trainer.state, jloss = jax_trainer._train_step(jax_trainer.state, jax.device_put(jb))
            jax_losses.append(float(jloss))
            losses.append(trainer.train_step(b).item())
    assert len(losses) == 10 and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jax_losses, rtol=STEP_RTOL)


def test_held_out_rollout_matches_jax(press):
    """The held-out press trajectory rolled out from equal weights and the
    trajectory's statistics: the port's ``rollout`` against the JAX one,
    both clamped to the truth off the NORMAL/OUTFLOW nodes."""
    param = _param(*press)
    ds, jax_ds = _datasets(param, val=True)
    frames = stack_graphs([ds[i] for i in ds.trajectory_indices(1)])
    jframes = jax.tree_util.tree_map(
        jnp.asarray, jax_stack_graphs([jax_ds[i] for i in jax_ds.trajectory_indices(1)]))
    n = int(frames.node_mask[0].sum())
    np.testing.assert_array_equal(frames.x[:, :n], np.asarray(jframes.x)[:, :n])
    jax_sim = jax_pp.get_simulator(param)
    first = jax.tree_util.tree_map(lambda a: a[0], jframes)
    variables = jax_sim.init({"params": jax.random.key(0)}, first)
    for t in range(jframes.x.shape[0]):
        frame = jax.tree_util.tree_map(lambda a, t=t: a[t], jframes)
        _, mut = jax_sim.apply(variables, frame, method=jax_simulator.Simulator.accumulate_stats,
                               mutable=["normalizer"])
        variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
    sim = get_simulator(param, device="cpu")
    load_reference_checkpoint(sim, export_reference_checkpoint(variables))
    want, targets = jax_rollout_mod.jitted_rollout(jax_sim, variables, jframes, jax.random.key(5))
    preds, port_targets = rollout(sim, frames, device="cpu")
    np.testing.assert_array_equal(port_targets[:, :n].numpy(), np.asarray(targets)[:, :n])
    np.testing.assert_allclose(preds[:, :n].numpy(), np.asarray(want)[:, :n], rtol=0,
                               atol=ROLLOUT_ATOL)
    moved = np.abs(np.asarray(want)[-1, :n] - frames.x[0, :n, :3]).max()
    assert moved > 10 * ROLLOUT_ATOL  # the rollout moved the plate


def test_grph_torch_train_plate_json(press, tmp_path):
    """One epoch of ``grph-torch train`` on ``plate.json`` (the published
    config, world edges at its default radius) on the press file, with node
    masking, 2 loader workers and prefetch, in a subprocess under a
    timeout: it validates on ``test.h5`` and writes its checkpoint."""
    param = json.loads((ROOT / "training_config" / "plate.json").read_text())
    param["dataset"].update(h5_path=press[0], meta_path=press[1])
    cfg = tmp_path / "plate.json"
    cfg.write_text(json.dumps(param))
    work = tmp_path / "work"
    work.mkdir()
    out = subprocess.run(
        [sys.executable, "-m", "graphphysics_torch.cli", "train", "--training_parameters_path",
         str(cfg), "--num_epochs", "1", "--batch_size", "2", "--warmup", "2",
         "--val_trajectories", "1", "--masking_ratio", "0.5", "--num_workers", "2",
         "--prefetch_factor", "2", "--progress", "off", "--device", "cpu"],
        cwd=work, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-4000:]
    assert "val_all_rollout_rmse=" in out.stdout
    assert (work / "checkpoints" / "state.pt").exists()
    rows = (work / "metrics.csv").read_text().splitlines()
    assert len(rows) >= 2

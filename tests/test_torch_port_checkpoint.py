"""Port twins of the JAX checkpoint tests, and checkpoints across the two
packages: a port checkpoint restores the whole training state, its metadata
rides inside the file and wins over a stale sidecar, ``load_checkpoint_with
_metadata`` reads the file once, the file loads in the JAX package's
``load_checkpoint`` (weights and normalizer statistics equal), and a JAX
``export_reference_checkpoint`` file loads in the port with a fresh
optimizer. Both model families, on the CPU."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.training import checkpoint as jax_checkpoint
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.training import (
    Trainer,
    get_simulator,
    is_torch_checkpoint,
    load_checkpoint,
    load_checkpoint_with_metadata,
    load_metadata,
    save_checkpoint,
)
from tests._torch_port_common import cylinder_param, port_trainer, write_cylinder_split

STATS = ("_acc_count", "_num_accumulations", "_acc_sum", "_acc_sum_squared")


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    return write_cylinder_split(tmp_path_factory.mktemp("cyl_ckpt"))


def _trained(cylinder, tmp_path, kind):
    """A port trainer after one epoch (5 steps), and its checkpoint's path."""
    trainer, loader, _ = port_trainer(cylinder_param(*cylinder, kind), tmp_path)
    trainer.fit(loader, num_epochs=1)
    return trainer, str(tmp_path / "ckpt" / "state.pt")


def _jax_trainer(param, tmp_path):
    """A JAX Trainer with initialized state on the fixture's val split."""
    edges = param["model"]["edge_input_size"] > 0
    ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges,
                                                            remove_noise=True),
                            use_edge_feature=edges, switch_to_val=True)
    trainer = JaxTrainer(param, checkpoint_dir=str(tmp_path / "jax_ckpt"), metrics_path=None,
                         rollout_dir=None, parallel_validation=False)
    trainer.init_state(JaxLoader(ds, batch_size=1, shuffle=False, prefetch=0).peek(), num_steps=1)
    return trainer, ds


def _assert_state_equal(sd, reference):
    """``sd`` (a port state_dict) against a reference-format checkpoint
    dict of numpy arrays, exactly."""
    for key, value in reference["model"].items():
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(value).reshape(sd[key].shape),
                                      err_msg=key)
    for name in ("_output_normalizer", "_node_normalizer", "_edge_normalizer"):
        if reference.get(name) is None:
            assert not any(k.startswith(name) for k in sd)
            continue
        for stat in STATS:
            np.testing.assert_array_equal(sd[f"{name}.{stat}"].numpy().ravel(),
                                          np.ravel(reference[name][stat]), err_msg=f"{name}.{stat}")


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_checkpoint_resume_roundtrip(cylinder, tmp_path, kind):
    trainer, ckpt = _trained(cylinder, tmp_path, kind)
    assert is_torch_checkpoint(ckpt)
    fresh, _, _ = port_trainer(cylinder_param(*cylinder, kind), tmp_path / "fresh", seed=7)
    fresh.init_state(10)
    load_checkpoint(ckpt, fresh)
    assert fresh.step == trainer.step == 5
    sd, want = fresh.sim.state_dict(), trainer.sim.state_dict()
    assert sd.keys() == want.keys()
    for key in want:
        assert torch.equal(sd[key], want[key]), key
    opt, want_opt = fresh.optimizer.state_dict(), trainer.optimizer.state_dict()
    for i, state in want_opt["state"].items():
        for name, value in state.items():
            assert torch.equal(opt["state"][i][name], value), (i, name)
    assert load_metadata(ckpt) == {"epoch": 1, "step": 5, "wandb_run_id": None}
    # a Simulator takes the weights and normalizers alone
    sim = get_simulator(cylinder_param(*cylinder, kind), device="cpu")
    load_checkpoint(ckpt, sim)
    for key, value in sim.state_dict().items():
        assert torch.equal(value, want[key]), key


def test_checkpoint_metadata_embedded_atomically(cylinder, tmp_path):
    """The metadata rides inside the state file (one os.replace commits
    both): a stale sidecar never wins over the embedded copy, a file without
    a sidecar still has its metadata, and the file holds nothing that
    ``torch.load(weights_only=True)`` refuses."""
    sim = get_simulator(cylinder_param(*cylinder, "epd"), device="cpu")
    ckpt = str(tmp_path / "state.pt")
    save_checkpoint(ckpt, sim, metadata={"epoch": 3, "batch_offset": 17})
    assert not os.path.exists(ckpt + ".tmp")
    with open(ckpt + ".meta.json", "w") as f:  # the previous save's sidecar
        json.dump({"epoch": 2, "batch_offset": 99}, f)
    assert load_metadata(ckpt) == {"epoch": 3, "batch_offset": 17}
    assert load_metadata(ckpt, prefer_sidecar=True) == {"epoch": 2, "batch_offset": 99}
    os.remove(ckpt + ".meta.json")
    assert load_metadata(ckpt) == {"epoch": 3, "batch_offset": 17}

    raw = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert set(raw) == {"model", "_output_normalizer", "_node_normalizer", "_edge_normalizer",
                        "optimizer", "scheduler", "step", "metadata"}
    assert raw["optimizer"] is None and raw["step"] == 0  # a Simulator has no optimizer
    restored = get_simulator(cylinder_param(*cylinder, "epd"), device="cpu")
    load_checkpoint(ckpt, restored)
    for key, value in sim.state_dict().items():
        assert torch.equal(restored.state_dict()[key], value), key


def test_load_checkpoint_with_metadata_single_parse(cylinder, tmp_path, monkeypatch):
    """One read of the file gives the state and the metadata of the two-call
    path; a file without embedded metadata falls back to the sidecar, then
    to ``{}``."""
    trainer, ckpt = _trained(cylinder, tmp_path, "epd")
    target, _, _ = port_trainer(cylinder_param(*cylinder, "epd"), tmp_path / "t")
    target.init_state(5)
    loads = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load", lambda *a, **k: loads.append(a) or real_load(*a, **k))
    got, meta = load_checkpoint_with_metadata(ckpt, target)
    assert got is target and len(loads) == 1
    monkeypatch.setattr(torch, "load", real_load)
    assert meta == load_metadata(ckpt) == {"epoch": 1, "step": 5, "wandb_run_id": None}
    for key, value in trainer.sim.state_dict().items():
        assert torch.equal(target.sim.state_dict()[key], value), key

    raw = torch.load(ckpt, map_location="cpu", weights_only=True)
    raw["metadata"] = None
    torch.save(raw, ckpt)
    assert load_checkpoint_with_metadata(ckpt, target)[1] == meta  # the sidecar's
    os.remove(ckpt + ".meta.json")
    assert load_checkpoint_with_metadata(ckpt, target)[1] == {}


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_port_checkpoint_loads_in_jax_load_checkpoint(cylinder, tmp_path, kind):
    """The JAX package's ``load_checkpoint`` reads a port file as a
    reference checkpoint: weights and normalizer statistics come over
    exactly, the JAX optimizer state stays its own."""
    trainer, ckpt = _trained(cylinder, tmp_path, kind)
    jax_trainer, _ = _jax_trainer(trainer.param, tmp_path)
    state = jax_checkpoint.load_checkpoint(ckpt, jax_trainer.state)
    assert int(state["step"]) == 0
    exported = export_reference_checkpoint({"params": state["params"],
                                            "normalizer": state["normalizer"]})
    _assert_state_equal(trainer.sim.state_dict(), exported)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_jax_reference_checkpoint_loads_in_port(cylinder, tmp_path, kind):
    """A JAX ``export_reference_checkpoint`` file restores weights and
    normalizers in the port and leaves its optimizer fresh; its metadata is
    empty."""
    param = cylinder_param(*cylinder, kind)
    jax_trainer, ds = _jax_trainer(param, tmp_path)
    # normalizer statistics that are not zero: fold one frame in
    g = jax.device_put(JaxLoader(ds, batch_size=1, shuffle=False, prefetch=0).peek())
    _, mutated = jax_trainer.sim.apply(
        {"params": jax_trainer.state["params"], "normalizer": jax_trainer.state["normalizer"]},
        g, is_training=True, mutable=["normalizer"])
    variables = {"params": jax_trainer.state["params"], "normalizer": mutated["normalizer"]}
    path = str(tmp_path / "reference.pt")
    reference = export_reference_checkpoint(variables, path)
    trainer = Trainer(param, metrics_path=None, rollout_dir=None, device="cpu")
    trainer.init_state(10)
    fresh_opt = trainer.optimizer.state_dict()
    _, meta = load_checkpoint_with_metadata(path, trainer)
    assert meta == {} and trainer.step == 0
    assert trainer.optimizer.state_dict() == fresh_opt
    _assert_state_equal(trainer.sim.state_dict(), reference)


def test_refuses_jax_msgpack_and_orbax(cylinder, tmp_path):
    param = cylinder_param(*cylinder, "epd")
    jax_trainer, _ = _jax_trainer(param, tmp_path)
    msgpack = str(tmp_path / "state.msgpack")
    jax_checkpoint.save_checkpoint(msgpack, jax_trainer.state, metadata={"epoch": 1})
    sim = get_simulator(param, device="cpu")
    with pytest.raises(ValueError, match="export_reference_checkpoint"):
        load_checkpoint(msgpack, sim)
    orbax = str(tmp_path / "state.orbax")
    jax_checkpoint.save_checkpoint(orbax, jax_trainer.state, metadata={"epoch": 1}, backend="orbax")
    with pytest.raises(ValueError, match="export_reference_checkpoint"):
        load_checkpoint(orbax, sim)
    # the port's own directory backend round-trips (it reads no orbax format)
    trainer, _, _ = port_trainer(param, tmp_path / "port", checkpoint_backend="orbax-async")
    trainer.init_state(10)
    trainer.save(0)
    restored = load_checkpoint(str(tmp_path / "port" / "ckpt" / "state.orbax"),
                               get_simulator(param, device="cpu"))
    for key, value in trainer.sim.state_dict().items():
        assert torch.equal(restored.state_dict()[key], value), key
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        Trainer(param, checkpoint_backend="msgpack", device="cpu")


@pytest.mark.parametrize("backend", ["orbax", "orbax-async"])
def test_orbax_checkpoint_backend_roundtrip(cylinder, tmp_path, backend):
    """Twin of the JAX test of that name: the directory backends (a
    ``torch.distributed.checkpoint`` directory in the port) through ``fit``,
    with the resume metadata, restored whole into a fresh Trainer."""
    from graphphysics_torch.training.checkpoint import wait_for_async_saves

    param = cylinder_param(*cylinder, "epd")
    trainer, loader, _ = port_trainer(param, tmp_path / backend, checkpoint_backend=backend)
    assert trainer.checkpoint_name == "state.orbax"
    trainer.fit(loader, num_epochs=1)
    wait_for_async_saves()
    ckpt = str(tmp_path / backend / "ckpt" / "state.orbax")
    assert os.path.isdir(ckpt) and os.path.isfile(os.path.join(ckpt, ".metadata"))
    assert load_metadata(ckpt)["epoch"] == 1
    assert load_metadata(ckpt, prefer_sidecar=True)["epoch"] == 1

    fresh, _, _ = port_trainer(param, tmp_path / f"{backend}_fresh", seed=7)
    fresh.init_state(10)
    _, meta = load_checkpoint_with_metadata(ckpt, fresh)
    assert meta["epoch"] == 1 and fresh.step == trainer.step
    for key, value in trainer.sim.state_dict().items():
        assert torch.equal(fresh.sim.state_dict()[key], value), key
    # the optimizer's slots and the schedule's position (its rate is the
    # current run's schedule at that position, as with the file backend)
    ours, theirs = fresh.optimizer.state_dict()["state"], trainer.optimizer.state_dict()["state"]
    assert ours.keys() == theirs.keys()
    for i, slots in theirs.items():
        for name, value in slots.items():
            assert torch.equal(ours[i][name], value), (i, name)
    assert fresh.scheduler.last_epoch == trainer.scheduler.last_epoch == trainer.step


def test_orbax_staged_save_never_clobbers_live_checkpoint(cylinder, tmp_path):
    """The directory backends stage into ``path.next`` and swap: a second
    save never removes the live checkpoint before the new one is whole, a
    finished but unswapped stage is the newest, and a crash between the two
    renames of the swap (the live path missing, ``.old`` left) still
    resolves to a whole checkpoint. An unfinished stage (no ``.metadata``)
    is passed over."""
    import shutil

    param = cylinder_param(*cylinder, "epd")
    trainer, _, _ = port_trainer(param, tmp_path / "stage")
    trainer.init_state(10)
    ckpt = str(tmp_path / "stage" / "state.orbax")
    save_checkpoint(ckpt, trainer, metadata={"epoch": 1}, backend="orbax")
    save_checkpoint(ckpt, trainer, metadata={"epoch": 2}, backend="orbax")
    assert os.path.isdir(ckpt)
    assert not os.path.exists(ckpt + ".next") and not os.path.exists(ckpt + ".old")
    assert load_metadata(ckpt)["epoch"] == 2

    # finished but not swapped (a crash before the swap): the newest wins
    os.rename(ckpt, ckpt + ".next")
    assert load_metadata(ckpt)["epoch"] == 2
    _, meta = load_checkpoint_with_metadata(ckpt, trainer)
    assert meta["epoch"] == 2
    os.rename(ckpt + ".next", ckpt)

    # a crash between rename(live -> .old) and rename(.next -> live)
    os.rename(ckpt, ckpt + ".old")
    assert load_metadata(ckpt)["epoch"] == 2
    os.rename(ckpt + ".old", ckpt)

    # an unfinished stage is passed over for the live checkpoint
    os.makedirs(ckpt + ".next")
    assert load_metadata(ckpt)["epoch"] == 2
    shutil.rmtree(ckpt + ".next")

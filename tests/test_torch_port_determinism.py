"""Port twins of ``tests/test_determinism.py``
(``graphphysics_torch/utils/determinism.py``): dataset items and Trainer
steps replay bit for bit on the CPU, and the checks report what differs."""

import numpy as np
import pytest
import torch

from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing
from graphphysics_torch.utils.determinism import (
    check_item_determinism,
    check_step_determinism,
    trainer_state,
    trainer_step,
)
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)
from tests.fixtures import write_cylinder_h5


@pytest.fixture()
def cylinder_ds(tmp_path):
    h5_path, meta_path = write_cylinder_h5(str(tmp_path), num_traj=1, steps=6, nx=8, ny=6)
    param = {
        "dataset": {"extension": "h5", "h5_path": h5_path, "meta_path": meta_path, "khop": 1},
        "model": {"type": "epd", "message_passing_num": 1, "hidden_size": 8,
                  "node_input_size": 2, "output_size": 2, "edge_input_size": 3},
        "index": {"feature_index_start": 0, "feature_index_end": 2,
                  "output_index_start": 0, "output_index_end": 2, "node_type_index": 2},
        "transformations": {"preprocessing": {"noise": 0.02, "noise_index_start": [0],
                                              "noise_index_end": [2], "masking": 0},
                            "world_pos_parameters": {"use": False}},
    }
    return get_dataset(param, get_preprocessing(param)), param


def test_item_determinism_with_noise(cylinder_ds):
    """The noise is drawn per (seed, epoch, index): an item rebuilt is the
    same bits, noisy columns included, and the noise did fire."""
    ds, _ = cylinder_ds
    report = check_item_determinism(ds, 1)
    assert report["deterministic"], report["mismatches"]
    g0 = ds[1]
    ds.set_epoch(1)
    g1 = ds[1]
    ds.set_epoch(0)
    assert not np.array_equal(np.asarray(g0.x), np.asarray(g1.x))


def test_step_determinism_of_a_trainer_step(cylinder_ds):
    """A Trainer step (forward with the normalizers' update, backward,
    AdamW, the schedule) replayed from cloned state is the same bits in
    every parameter, statistic, optimizer slot and the loss."""
    ds, param = cylinder_ds
    trainer = Trainer(param, metrics_path=None, rollout_dir=None, device="cpu")
    trainer.init_state(num_steps=10)
    batch = ds[0].to("cpu")
    trainer.train_step(batch)  # the optimizer's slots exist from here on
    report = check_step_determinism(trainer_step(trainer), trainer_state(trainer), batch, runs=3)
    assert report["deterministic"], report["mismatches"]
    assert report["compared"] > 3 * len(list(trainer.sim.parameters()))  # weights, exp_avg, exp_avg_sq


def test_mismatch_is_reported():
    """The comparison bites: perturbed trees report the leaf paths, with
    the size of the difference, for tensors as for arrays."""
    a = {"w": torch.ones(4), "b": np.zeros((2,), np.float32)}
    b = {"w": torch.ones(4), "b": np.full((2,), 1e-9, np.float32)}
    calls = [a, b]

    def fake_step(state, batch):
        return calls.pop(0)

    report = check_step_determinism(fake_step, {}, {}, runs=2)
    assert not report["deterministic"]
    assert report["mismatches"] == ["['b']"]
    assert report["max_abs_diff"]["['b']"] == pytest.approx(1e-9)
    bf16 = [{"w": torch.ones(3, dtype=torch.bfloat16)},
            {"w": torch.tensor([1.0, 1.0, 1.0078125], dtype=torch.bfloat16)}]
    report = check_step_determinism(lambda s, b: bf16.pop(0), {}, {}, runs=2)
    assert report["mismatches"] == ["['w']"]


def test_structure_mismatch_is_reported():
    """Extra or missing leaves are a structure mismatch, not a zip cut
    short into a false 'deterministic'."""
    calls = [
        {"w": torch.ones(4)},
        {"w": torch.ones(4), "extra": torch.zeros(1)},
    ]

    def fake_step(state, batch):
        return calls.pop(0)

    report = check_step_determinism(fake_step, {}, {}, runs=2)
    assert not report["deterministic"]
    assert any("structure" in m for m in report["mismatches"])

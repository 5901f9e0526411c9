"""Port parity, GMM training: 10 train steps of the port's ``Trainer`` with a
Gaussian-mixture head against the JAX ``Trainer`` from equal weights, for
both model families and both heads (diagonal and full covariance); the
per-trajectory generators of ``validate`` and ``predict``; ``fit`` with a
GMM head (``val_loss`` None); GMM checkpoints across the two packages.
Torch twins of ``test_trainer.py::test_fit_gmm_head`` and
``test_fit_full_cov_gmm_head``. Everything runs on the CPU, on the
``write_cylinder_h5`` fixture."""

import contextlib
import copy
import csv

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.training import checkpoint as jax_checkpoint
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.dataset import GraphLoader
from graphphysics_torch.training import (
    Trainer,
    get_dataset,
    get_preprocessing,
    load_checkpoint_with_metadata,
    rollout_rmse,
)
from graphphysics_torch.training.trainer import trajectory_generator
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests._torch_port_common import cylinder_param, port_trainer, write_cylinder_split

# step losses over 10 steps: f32 forward and backward in another order (XLA
# vs ATen), the NLL's exp / logsumexp (and the full head's triangular solve),
# then AdamW's normalized updates, as tests/test_torch_port_training.py
STEP_RTOL = 2e-5
# the key bias (0 gradient in exact arithmetic) against the other leaves
KBIAS_GRAD_SHARE = 1e-6


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    return write_cylinder_split(tmp_path_factory.mktemp("cyl_gmm"))


def _gmm_param(cylinder, kind, use_diagonal=True, K=3, hidden=32):
    param = cylinder_param(*cylinder, kind, hidden=hidden)
    param["model"].update({"num_mixture_components": K, "temperature": 1.0,
                           "use_diagonal": use_diagonal})
    return param


@pytest.mark.parametrize("use_diagonal", [True, False], ids=["diag", "full"])
@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_ten_gmm_train_steps_match_the_jax_trainer(cylinder, kind, use_diagonal):
    param = _gmm_param(cylinder, kind, use_diagonal)
    edges = kind == "epd"
    jax_layout = {"edge_layout": "csr"} if kind == "transformer" else {}
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges),
                                use_edge_feature=edges, **jax_layout)
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=edges), use_edge_feature=edges)
    jax_loader = JaxLoader(jax_ds, batch_size=2, shuffle=True, prefetch=0)
    loader = GraphLoader(ds, batch_size=2, shuffle=True)
    interpret = pltpu.force_tpu_interpret_mode() if kind == "transformer" else contextlib.nullcontext()
    with interpret:
        jax_trainer = JaxTrainer(param, learning_rate=1e-3, warmup=3, metrics_path=None,
                                 rollout_dir=None)
        jax_trainer.init_state(jax.device_put(jax_loader.peek()), 10)
        trainer = Trainer(param, learning_rate=1e-3, warmup=3, device="cpu")
        trainer.init_state(10)
        assert (trainer.K, trainer.use_diagonal, trainer.temperature) == (3, use_diagonal, 1.0)
        assert (jax_trainer.K, jax_trainer.use_diagonal) == (3, use_diagonal)
        state = jax_trainer.state
        load_reference_checkpoint(
            trainer.sim,
            export_reference_checkpoint({"params": state["params"], "normalizer": state["normalizer"]}),
        )
        kbias = [n for n, _ in trainer.sim.named_parameters() if n.endswith("k_proj.bias")]
        losses, jax_losses_, kbias_share = [], [], []
        for epoch in range(2):  # 5 batches of 2 frames an epoch
            jax_loader.set_epoch(epoch)
            loader.set_epoch(epoch)
            for jb, b in zip(jax_loader, loader):
                jax_trainer.state, jloss = jax_trainer._train_step(jax_trainer.state, jax.device_put(jb))
                jax_losses_.append(float(jloss))
                losses.append(trainer.train_step(b).item())
                grads = {n: p.grad.abs().max().item() for n, p in trainer.sim.named_parameters()}
                if kbias:
                    kbias_share.append(max(grads[k] for k in kbias)
                                       / max(g for n, g in grads.items() if n not in kbias))
    assert len(losses) == 10 and all(np.isfinite(losses))
    np.testing.assert_allclose(losses, jax_losses_, rtol=STEP_RTOL)
    assert all(share < KBIAS_GRAD_SHARE for share in kbias_share), kbias_share


def test_trajectory_generators_do_not_depend_on_other_trajectories(cylinder, tmp_path):
    """A trajectory's draws come from ``(seed, trajectory)`` alone: its
    sampled rollout is the same whether or not others were rolled out
    before it; ``validate`` seeds with ``seed + epoch`` and ``predict`` with
    ``seed``, so both repeat exactly."""
    param = _gmm_param(cylinder, "epd")
    trainer, loader, val_ds = port_trainer(param, tmp_path, seed=5)
    trainer.init_state(10)
    for batch in loader:
        trainer.sim(batch.to("cpu"), is_training=True)  # normalizer statistics
    trainer.sim.eval()
    a = torch.Generator().manual_seed(0)
    assert torch.equal(trajectory_generator(9, 1, "cpu").get_state(),
                       trajectory_generator(9, 1, "cpu").get_state())
    assert not torch.equal(trajectory_generator(9, 1, "cpu").get_state(),
                           trajectory_generator(9, 2, "cpu").get_state())
    assert not torch.equal(trajectory_generator(9, 1, "cpu").get_state(), a.get_state())

    alone = trainer._rollout_trajectory(val_ds, 1, trainer.seed)[1]
    both = trainer.predict(val_ds, save_dir=None, max_trajectories=2)
    np.testing.assert_array_equal(both[1], alone.numpy())
    assert not np.array_equal(both[0], both[1])
    again = trainer.predict(val_ds, save_dir=None, max_trajectories=2)
    for x, y in zip(both, again):
        np.testing.assert_array_equal(x, y)

    epoch = 3
    rmse = trainer.validate(val_ds, epoch=epoch, max_trajectories=2, save_rollout=False)
    assert trainer.last_val_loss is None
    se, cnt = 0.0, 0.0
    for t in range(2):
        frames, preds, targets = trainer._rollout_trajectory(val_ds, t, trainer.seed + epoch)
        n = float(frames.node_mask[0].sum()) * preds.shape[0] * preds.shape[-1]
        se += float(rollout_rmse(preds, targets, frames.node_mask[0])) ** 2 * n
        cnt += n
    assert rmse == float((se / cnt) ** 0.5)
    assert trainer.validate(val_ds, epoch=epoch, max_trajectories=2, save_rollout=False) == rmse


@pytest.mark.parametrize("use_diagonal", [True, False], ids=["diag", "full"])
def test_fit_gmm_head(cylinder, tmp_path, use_diagonal):
    """Twins of ``test_fit_gmm_head`` and ``test_fit_full_cov_gmm_head``:
    the NLL trains, the sampled rollout validates, ``val_loss`` is None and
    the metrics file has none."""
    param = _gmm_param(cylinder, "epd", use_diagonal, K=2)
    trainer, loader, val_ds = port_trainer(param, tmp_path, log_every=5)
    assert trainer.use_diagonal is use_diagonal
    history = trainer.fit(loader, val_dataset=val_ds, num_epochs=1)
    assert np.isfinite(history["train_loss"][0]) and np.isfinite(history["val_rmse"][0])
    assert trainer.last_val_loss is None
    per = 5 if use_diagonal else 6
    assert trainer.sim.model.decode_module.proj.out_features == 2 * per
    rows = list(csv.DictReader(open(tmp_path / "metrics.csv")))
    assert rows[-1]["val_all_rollout_rmse"] and not rows[-1].get("val_loss")


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_gmm_checkpoints_cross_the_two_packages(cylinder, tmp_path, kind):
    """A port GMM checkpoint loads in the JAX ``load_checkpoint`` (weights
    and statistics equal), and a JAX-exported GMM state loads in the port
    (``strict=True``, every key present)."""
    param = _gmm_param(cylinder, kind, K=2, hidden=16)
    trainer, loader, _ = port_trainer(param, tmp_path)
    trainer.fit(loader, num_epochs=1)
    ckpt = str(tmp_path / "ckpt" / "state.pt")
    edges = kind == "epd"
    ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges,
                                                            remove_noise=True),
                            use_edge_feature=edges, switch_to_val=True)
    jax_trainer = JaxTrainer(param, checkpoint_dir=str(tmp_path / "jax_ckpt"), metrics_path=None,
                             rollout_dir=None, parallel_validation=False)
    jax_trainer.init_state(JaxLoader(ds, batch_size=1, shuffle=False, prefetch=0).peek(), num_steps=1)
    state = jax_checkpoint.load_checkpoint(ckpt, jax_trainer.state)
    exported = export_reference_checkpoint({"params": state["params"], "normalizer": state["normalizer"]})
    sd = trainer.sim.state_dict()
    assert {"model.decode_module.pre_proj.weight", "model.decode_module.proj.weight"} <= set(exported["model"])
    for key, value in exported["model"].items():
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(value).reshape(sd[key].shape),
                                      err_msg=key)

    path = str(tmp_path / "reference.pt")
    reference = export_reference_checkpoint(
        {"params": jax_trainer.state["params"], "normalizer": jax_trainer.state["normalizer"]}, path)
    fresh = Trainer(copy.deepcopy(param), metrics_path=None, rollout_dir=None, device="cpu")
    fresh.init_state(10)
    load_checkpoint_with_metadata(path, fresh)
    got = fresh.sim.state_dict()
    for key, value in reference["model"].items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value).reshape(got[key].shape),
                                      err_msg=key)
    model_keys = {k for k in got if "_normalizer." not in k}
    assert model_keys == set(reference["model"])

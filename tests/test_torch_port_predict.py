"""Port twins of the JAX trainer's validation and prediction tests, and
their parity with the JAX package from the same checkpoint: ``validate``'s
``val_loss`` and its XDMF export of trajectory 0, ``predict`` writing one
``graph_{trajectory}.xdmf`` per trajectory, the port's predictions against
the JAX ``Trainer.predict`` (arrays, and the port's files read through the
JAX ``XdmfTimeSeriesReader``). Both model families, on the CPU; the JAX
side runs the unsorted (COO) layout, without Pallas."""

import os

import numpy as np
import pytest

from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.training import checkpoint as jax_checkpoint
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.xdmf import XdmfTimeSeriesReader as JaxReader
from graphphysics_torch.training import Trainer, load_checkpoint
from graphphysics_torch.utils import XdmfTimeSeriesReader
from tests._torch_port_common import cylinder_param, port_trainer, write_cylinder_split

# rollouts of 5 frames from equal weights, f32 in two summation orders
ROLLOUT_ATOL = 1e-4
# the epoch-mean masked L2 of those rollouts
VAL_LOSS_RTOL = 2e-5


@pytest.fixture(scope="module")
def cylinder(tmp_path_factory):
    return write_cylinder_split(tmp_path_factory.mktemp("cyl_predict"))


@pytest.fixture(scope="module", params=["epd", "transformer"])
def trained(request, cylinder, tmp_path_factory):
    """(port trainer after one epoch, its checkpoint, its val split), and
    a JAX Trainer that loaded the checkpoint, with its val split."""
    tmp = tmp_path_factory.mktemp(f"trained_{request.param}")
    trainer, loader, val_ds = port_trainer(cylinder_param(*cylinder, request.param), tmp)
    trainer.fit(loader, num_epochs=1)
    ckpt = str(tmp / "ckpt" / "state.pt")
    param = trainer.param
    edges = param["model"]["edge_input_size"] > 0
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(param, use_edge_feature=edges,
                                                                remove_noise=True),
                                use_edge_feature=edges, switch_to_val=True)
    jax_trainer = JaxTrainer(param, metrics_path=None, rollout_dir=None,
                             checkpoint_dir=str(tmp / "jax_ckpt"), parallel_validation=False)
    jax_trainer.init_state(JaxLoader(jax_ds, batch_size=1, shuffle=False, prefetch=0).peek(), 1)
    jax_trainer.state = jax_checkpoint.load_checkpoint(ckpt, jax_trainer.state)
    return trainer, ckpt, val_ds, jax_trainer, jax_ds


def test_predict_writes_xdmf(trained, tmp_path):
    trainer, ckpt, val_ds, _, _ = trained
    fresh = Trainer(trainer.param, metrics_path=None, rollout_dir=None, device="cpu")
    fresh.init_state(1)
    load_checkpoint(ckpt, fresh.sim)
    out = fresh.predict(val_ds, save_dir=str(tmp_path / "predictions"))
    assert len(out) == val_ds.size_dataset
    files = sorted(os.listdir(tmp_path / "predictions"))
    # h5 trajectories have no mesh id: named by their number, as in JAX
    assert [f for f in files if f.endswith(".xdmf")] == ["graph_0.xdmf", "graph_1.xdmf"]
    with XdmfTimeSeriesReader(str(tmp_path / "predictions" / "graph_1.xdmf")) as r:
        assert r.num_steps == val_ds.trajectory_length - 1
        t, pd, _ = r.read_data(0)
        assert t == pytest.approx(val_ds.dt)
        n = r.num_points()
        np.testing.assert_array_equal(pd["prediction"], out[1][0, :n])
    # without a directory nothing is written, and the same arrays come back
    again = fresh.predict(val_ds, save_dir=None, max_trajectories=1)
    assert len(again) == 1
    np.testing.assert_array_equal(again[0], out[0])
    # the in-memory model predicts the same
    np.testing.assert_array_equal(trainer.predict(val_ds, save_dir=None)[0], out[0])


def test_port_predictions_match_jax_predict(trained, tmp_path):
    """``Trainer.predict`` of both packages from one port checkpoint: the
    arrays, and the port's XDMF files read by the JAX reader."""
    trainer, ckpt, val_ds, jax_trainer, jax_ds = trained
    want = jax_trainer.predict(jax_ds, save_dir=str(tmp_path / "jax"))
    got = trainer.predict(val_ds, save_dir=str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for traj, (a, b) in enumerate(zip(got, want)):
        n = val_ds._load(val_ds.trajectory_indices(traj)[0]).num_nodes
        np.testing.assert_allclose(a[:, :n], np.asarray(b)[:, :n], rtol=0, atol=ROLLOUT_ATOL)
        with JaxReader(str(tmp_path / "port" / f"graph_{traj}.xdmf")) as r, \
                JaxReader(str(tmp_path / "jax" / f"graph_{traj}.xdmf")) as j:
            np.testing.assert_array_equal(r.read_points_cells()[0], j.read_points_cells()[0])
            np.testing.assert_array_equal(r.read_points_cells()[1][0][1], j.read_points_cells()[1][0][1])
            assert r.num_steps == j.num_steps == a.shape[0]
            for k in range(r.num_steps):
                t, pd, _ = r.read_data(k)
                tj, pj, _ = j.read_data(k)
                assert t == pytest.approx(tj)
                np.testing.assert_allclose(pd["prediction"], pj["prediction"], rtol=0,
                                           atol=ROLLOUT_ATOL)


def test_validate_logs_val_loss(trained, tmp_path):
    """The epoch-mean masked L2 of the denormalized rollout predictions
    (``val_loss``) next to the all-rollout RMSE, against the JAX
    ``validate`` from the same weights; trajectory 0's rollout exported."""
    trainer, _, val_ds, jax_trainer, jax_ds = trained
    trainer.rollout_dir = str(tmp_path / "meshes")
    rmse = trainer.validate(val_ds, epoch=3)
    assert np.isfinite(rmse) and np.isfinite(trainer.last_val_loss)
    want_rmse = jax_trainer.validate(jax_ds, save_rollout=False)
    np.testing.assert_allclose(trainer.last_val_loss, jax_trainer.last_val_loss, rtol=VAL_LOSS_RTOL)
    np.testing.assert_allclose(rmse, want_rmse, rtol=VAL_LOSS_RTOL)
    exported = sorted(os.listdir(tmp_path / "meshes" / "epoch_3"))
    assert exported == ["graph_epoch_3_0.h5", "graph_epoch_3_0.xdmf"]
    trainer.rollout_dir = None
    trainer.validate(val_ds, epoch=4, save_rollout=True)
    assert not os.path.exists(tmp_path / "meshes" / "epoch_4")

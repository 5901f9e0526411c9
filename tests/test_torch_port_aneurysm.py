"""Port parity, the aneurysm configurations (coarse-aneurysm, c-a-gmm) at a
small size on the JAX package's synthetic tetrahedral XDMF trajectories:
the feature hooks (``build_features``, ``add_bezier_node_type``) and
``tetra_to_faces`` against JAX exactly; 10 train steps with the aneurysm
features and previous-frame data through both ``Trainer``s, plain and K = 3
GMM head, and on the data where the normalizer's round-off parts them, the
same steps from equal statistics; the rollout with the previous-data slice fed back against the JAX
``rollout`` (the GMM one with the JAX draws fed to the port's sampler, the
shared-draw scheme of ``test_torch_port_gmm.py``); ``predict`` writing
tetrahedral XDMF whose times start at ``2 * dt``, against the JAX
``Trainer.predict``. Twins of ``test_dataset.py`` (XDMF, previous data),
``test_preprocessing_extra.py`` (hooks) and ``test_rollout.py`` (previous
data). The JAX side runs the unsorted (COO) layout, without Pallas."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core.graph import stack_graphs as jax_stack_graphs
from graphphysics_tpu.dataset import GraphLoader as JaxLoader
from graphphysics_tpu.dataset.sample import RawSample as JaxRawSample
from graphphysics_tpu.external import add_bezier_node_type as jax_bezier
from graphphysics_tpu.external import build_features as jax_build_features
from graphphysics_tpu.models import simulator as jax_simulator
from graphphysics_tpu.topology import tetra_to_faces as jax_tetra_to_faces
from graphphysics_tpu.training import checkpoint as jax_checkpoint
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training import rollout as jax_rollout_mod
from graphphysics_tpu.training.trainer import Trainer as JaxTrainer
from graphphysics_tpu.utils.synthetic import write_aneurysm_xdmf
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_tpu.utils.xdmf import XdmfTimeSeriesReader as JaxReader
from graphphysics_torch.core.graph import stack_graphs
from graphphysics_torch.dataset import GraphLoader, RawSample
from graphphysics_torch.external import add_bezier_node_type, build_features
from graphphysics_torch.models import simulator as port_simulator
from graphphysics_torch.topology import tetra_to_faces
from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing, load_checkpoint, rollout
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# step losses over 10 steps: f32 forward and backward in another order (XLA
# vs ATen), then AdamW's normalized updates, as test_torch_port_training.py
STEP_RTOL = 2e-5
# rollouts of 4 frames from equal weights, f32 in two summation orders, with
# the previous-data slice fed back
ROLLOUT_ATOL = 1e-4
PREVIOUS = (5, 8)
STEPS = 7


# the seeds of benchmarks/fidelity_aneurysm.py's training and held-out
# splits. The node normalizer's variance, E[x^2] - E[x]^2 in f32 in both
# packages, loses the digits of a feature column whose spread is a small
# fraction of its mean, and the two packages sum the batch in other orders:
# on the unseeded trajectories the inflow-acceleration minimum (column 12)
# is one value to within an ulp, its normalized values are rounding noise,
# and the step losses of the packages differ by up to 3.8e-3 (plain) and
# 0.42 (GMM) relative; with seed 2 the GMM's first step, a column's
# spread down to 1.3% of its mean, differs by 1.3e-4. On these splits the
# narrowest spread is 4.2% and the losses agree to STEP_RTOL.
# test_unseeded_step_gap_is_the_normalizer_roundoff reads the unseeded case.
TRAIN_SEED, HELD_OUT_SEED = 0, 12345


@pytest.fixture(scope="module")
def aneurysm(tmp_path_factory):
    """Two training and two held-out trajectories of 7 frames on
    ``tet_grid(4)``, written by the JAX package (the directory name holds no
    other "train")."""
    root = tmp_path_factory.mktemp("aneurysm_data")
    folder, meta_path = write_aneurysm_xdmf(str(root / "train"), num_traj=2, steps=STEPS, n=4,
                                            seed=TRAIN_SEED)
    write_aneurysm_xdmf(str(root / "test"), num_traj=2, steps=STEPS, n=4, seed=HELD_OUT_SEED)
    return folder, meta_path


@pytest.fixture(scope="module")
def unseeded(tmp_path_factory):
    """The training split of ``aneurysm`` written without a seed: the
    phase ramp whose inflow statistics are constant to within an ulp."""
    root = tmp_path_factory.mktemp("aneurysm_unseeded")
    return write_aneurysm_xdmf(str(root / "train"), num_traj=2, steps=STEPS, n=4)


def _param(folder, meta_path, K=0):
    """coarse-aneurysm.json cut to 2 blocks of width 16 (4 heads), its noise
    scaled to the synthetic field; with ``K`` the c-a-gmm head."""
    model = {"type": "transformer", "message_passing_num": 2, "hidden_size": 16,
             "node_input_size": 14, "edge_input_size": 0, "output_size": 3, "num_heads": 4}
    if K:
        model.update(num_mixture_components=K, temperature=1)
    return {
        "dataset": {"extension": "xdmf", "xdmf_folder": folder, "meta_path": meta_path,
                    "khop": 1, "new_edges_ratio": 0},
        "model": model,
        "index": {"feature_index_start": 0, "feature_index_end": 14, "output_index_start": 0,
                  "output_index_end": 3, "node_type_index": 14},
        "transformations": {
            "preprocessing": {"noise": [0.02, 0.02, 0.02, 0.01, 0.01, 0.01],
                              "noise_index_start": [0, 1, 2, 5, 6, 7],
                              "noise_index_end": [1, 2, 3, 6, 7, 8]},
            "world_pos_parameters": {"use": False},
        },
    }


def _datasets(param, val=False):
    """(port dataset, JAX dataset in the COO layout) with the aneurysm hook
    and previous data; ``val``: the held-out split without noise."""
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=False, remove_noise=val,
                                              extra_node_features=build_features),
                     use_edge_feature=False, use_previous_data=True, switch_to_val=val)
    jax_ds = jax_pp.get_dataset(param, jax_pp.get_preprocessing(
        param, use_edge_feature=False, remove_noise=val, extra_node_features=jax_build_features),
        use_edge_feature=False, use_previous_data=True, switch_to_val=val)
    return ds, jax_ds


def _options():
    return {"use_previous_data": True, "previous_data_start": PREVIOUS[0],
            "previous_data_end": PREVIOUS[1]}


def _raw(seed, n=40, width=8):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, width)).astype(np.float32)
    pos = r.normal(size=(n, 3)).astype(np.float32)
    pos[: n // 2, 1] = 0.0  # on the inflow/outflow plane
    pos[n // 4 : n // 2, 0] = 0.0  # x == 0: both INFLOW and OUTFLOW, OUTFLOW wins
    return x, pos, r


def test_build_features_matches_jax():
    x, pos, r = _raw(0, width=5)
    x[:, 3] = r.integers(0, 2, len(x))  # the wall mask
    y = r.normal(size=(len(x), 3)).astype(np.float32)
    prev = {"Vitesse": r.normal(size=(len(x), 3)).astype(np.float32)}
    ours = build_features(RawSample(x=x.copy(), pos=pos, y=y, previous_data=prev), None)
    theirs = jax_build_features(JaxRawSample(x=x.copy(), pos=pos, y=y, previous_data=prev), None)
    assert ours.x.dtype == theirs.x.dtype == np.float32 and ours.x.shape == (len(x), 15)
    np.testing.assert_array_equal(ours.x, theirs.x)
    assert set(np.unique(ours.x[:, 14])) >= {0.0, 4.0, 5.0, 6.0}


def test_bezier_node_type_matches_jax():
    x, pos, r = _raw(1)
    x[:, 3:8] = r.integers(0, 2, (len(x), 5))
    x[:5, 3:8] = [1, 0, 0, 0, 0]  # walls
    ours = add_bezier_node_type(RawSample(x=x.copy(), pos=pos), None)
    theirs = jax_bezier(JaxRawSample(x=x.copy(), pos=pos), None)
    assert ours.x.shape == (len(x), 9)
    np.testing.assert_array_equal(ours.x, theirs.x)
    assert set(np.unique(ours.x[:, 8])) >= {0.0, 4.0, 5.0, 6.0}


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_tetra_to_faces_matches_jax(dtype):
    tets = np.random.default_rng(2).integers(0, 50, (17, 4)).astype(dtype)
    ours, theirs = tetra_to_faces(tets), jax_tetra_to_faces(tets)
    assert ours.shape == (68, 3) and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError):
        tetra_to_faces(tets[:, :3])


def test_preprocessing_runs_the_hook_first(aneurysm):
    param = _param(*aneurysm)
    names = [getattr(s, "func", s).__name__
             for s in get_preprocessing(param, use_edge_feature=False,
                                        extra_node_features=build_features).steps]
    jax_names = [getattr(s, "func", s).__name__
                 for s in jax_pp.get_preprocessing(param, use_edge_feature=False,
                                                   extra_node_features=jax_build_features).steps]
    assert names == jax_names == ["build_features", "add_noise", "apply_face_to_edge"]


def _ten_steps(param, shared_statistics=False):
    """10 train steps (2 epochs of 5 batches of 2 frames) through both
    ``Trainer``s from equal weights. The normalizers start empty or, with
    ``shared_statistics``, from the statistics JAX accumulates over the
    first epoch's batches, copied to the port. Returns (port, JAX) losses."""
    ds, jax_ds = _datasets(param)
    assert len(ds) == len(jax_ds) == 2 * (STEPS - 2)
    loader = GraphLoader(ds, batch_size=2, shuffle=True)
    jax_loader = JaxLoader(jax_ds, batch_size=2, shuffle=True, prefetch=0)
    jax_trainer = JaxTrainer(param, learning_rate=1e-3, warmup=3, metrics_path=None,
                             rollout_dir=None, **_options())
    jax_trainer.init_state(jax.device_put(jax_loader.peek()), 10)
    trainer = Trainer(param, learning_rate=1e-3, warmup=3, device="cpu", **_options())
    trainer.init_state(10)
    state = jax_trainer.state
    if shared_statistics:
        variables = {"params": state["params"], "normalizer": state["normalizer"]}
        for jb in jax_loader:
            _, mut = jax_trainer.sim.apply(variables, jax.device_put(jb), mutable=["normalizer"],
                                           method=jax_simulator.Simulator.accumulate_stats)
            variables["normalizer"] = mut["normalizer"]
        state["normalizer"] = variables["normalizer"]
    load_reference_checkpoint(
        trainer.sim,
        export_reference_checkpoint({"params": state["params"], "normalizer": state["normalizer"]}),
    )
    losses, jax_losses = [], []
    for epoch in range(2):
        loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        for b, jb in zip(loader, jax_loader):
            np.testing.assert_array_equal(b.x[b.node_mask], np.asarray(jb.x)[np.asarray(jb.node_mask)])
            jax_trainer.state, jloss = jax_trainer._train_step(jax_trainer.state, jax.device_put(jb))
            jax_losses.append(float(jloss))
            losses.append(trainer.train_step(b).item())
    assert len(losses) == 10 and all(np.isfinite(losses))
    return np.array(losses), np.array(jax_losses)


@pytest.mark.parametrize("K", [0, 3], ids=["plain", "gmm"])
def test_ten_train_steps_match_the_jax_trainer(aneurysm, K):
    losses, jax_losses = _ten_steps(_param(*aneurysm, K=K))
    np.testing.assert_allclose(losses, jax_losses, rtol=STEP_RTOL)


@pytest.mark.parametrize("K", [0, 3], ids=["plain", "gmm"])
def test_unseeded_step_gap_is_the_normalizer_roundoff(unseeded, K):
    """The open normalizer fault (ROADMAP, faults of the port), on the data
    that shows it: from empty statistics the packages' step losses differ
    by more than ``STEP_RTOL`` (3.8e-3 plain, 0.42 GMM read); from equal
    statistics accumulated over every training frame, where no column is
    constant, the same 10 steps agree within it (8.5e-8 and 8.0e-7 read).
    The gap is the f32 variance of the near-constant columns, nothing else."""
    param = _param(*unseeded, K=K)
    losses, jax_losses = _ten_steps(param)
    assert np.max(np.abs(losses - jax_losses) / np.abs(jax_losses)) > STEP_RTOL
    losses, jax_losses = _ten_steps(param, shared_statistics=True)
    np.testing.assert_allclose(losses, jax_losses, rtol=STEP_RTOL)


def _carried_pair(param, frames_jax):
    """A JAX Simulator initialized from seed 0 with the statistics of the
    frames, and the port Simulator on the CPU with its weights."""
    from graphphysics_torch.training import get_simulator

    jax_sim = jax_pp.get_simulator(param)
    first = jax.tree_util.tree_map(lambda a: a[0], frames_jax)
    variables = jax_sim.init({"params": jax.random.key(0), "sample": jax.random.key(1)}, first)
    for t in range(frames_jax.x.shape[0]):
        frame = jax.tree_util.tree_map(lambda a, t=t: a[t], frames_jax)
        _, mut = jax_sim.apply(variables, frame, method=jax_simulator.Simulator.accumulate_stats,
                               mutable=["normalizer"])
        variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
    sim = get_simulator(param, device="cpu")
    load_reference_checkpoint(sim, export_reference_checkpoint(variables))
    return jax_sim, variables, sim


@pytest.mark.parametrize("K", [0, 3], ids=["plain", "gmm"])
def test_previous_data_rollout_matches_jax(aneurysm, monkeypatch, K):
    """The held-out trajectory rolled out with ``x[:, 5:8]`` fed back: the
    port's ``rollout`` against the JAX one, both clamped, within
    ``ROLLOUT_ATOL``. With K = 3 the JAX sampler runs eagerly and records
    its draws (component ids and normals, its own split), which the port's
    sampler is then fed in frame order (as Gumbel draws that pick the JAX
    component)."""
    param = _param(*aneurysm, K=K)
    ds, jax_ds = _datasets(param, val=True)
    frames = stack_graphs([ds[i] for i in ds.trajectory_indices(0)])
    jframes = jax.tree_util.tree_map(
        jnp.asarray, jax_stack_graphs([jax_ds[i] for i in jax_ds.trajectory_indices(0)]))
    n = int(frames.node_mask[0].sum())
    np.testing.assert_array_equal(frames.x[:, :n], np.asarray(jframes.x)[:, :n])
    jax_sim, variables, sim = _carried_pair(param, jframes)
    draws = []
    if K:
        jax_sampler = jax_simulator.sample_gmm_diagonal

        def recording(key, net, d, K, temperature):
            n_rows = net.shape[0]
            k_rng, z_rng = jax.random.split(key)
            logits = net.reshape(n_rows, K, 2 * d + 1)[..., 0]
            draws.append((torch.from_numpy(np.array(jax.random.categorical(k_rng, logits, axis=-1))),
                          torch.from_numpy(np.array(jax.random.normal(z_rng, (n_rows, d),
                                                                      dtype=jnp.float32)))))
            return jax_sampler(key, net, d=d, K=K, temperature=temperature)

        monkeypatch.setattr(jax_simulator, "sample_gmm_diagonal", recording)
        with jax.disable_jit():
            want, targets = jax_rollout_mod.rollout(jax_sim, variables, jframes, jax.random.key(5),
                                                    **_options())
        fed = iter(list(draws))

        def shared(n_rows, K, d, generator, dtype):
            # Gumbel draws of -inf but at the JAX component: argmax takes it
            comp, z = next(fed)
            gumbel = torch.full((n_rows, K), -torch.inf, dtype=dtype)
            gumbel[torch.arange(n_rows), comp.long()] = 0.0
            return gumbel, z

        monkeypatch.setattr(port_simulator, "draw_gmm", shared)
    else:
        want, targets = jax_rollout_mod.jitted_rollout(jax_sim, variables, jframes,
                                                       jax.random.key(5), **_options())
    preds, port_targets = rollout(sim, frames, device="cpu",
                                  generator=torch.Generator().manual_seed(0), **_options())
    assert len(draws) == (frames.x.shape[0] if K else 0)
    np.testing.assert_array_equal(port_targets[:, :n].numpy(), np.asarray(targets)[:, :n])
    np.testing.assert_allclose(preds[:, :n].numpy(), np.asarray(want)[:, :n], rtol=0,
                               atol=ROLLOUT_ATOL)
    if not K:  # the slice was fed: without it the rollout differs
        unfed, _ = rollout(sim, frames, device="cpu")
        assert not torch.allclose(unfed[1:], preds[1:], atol=ROLLOUT_ATOL)


def test_rollout_refuses_a_previous_slice_of_another_width(aneurysm):
    param = _param(*aneurysm)
    ds, _ = _datasets(param, val=True)
    from graphphysics_torch.training import get_simulator

    with pytest.raises(ValueError, match="as wide as the output"):
        rollout(get_simulator(param, device="cpu"), stack_graphs([ds[0]]), device="cpu",
                use_previous_data=True, previous_data_start=5, previous_data_end=7)


def test_predict_writes_tetra_xdmf_from_two_dt(aneurysm, tmp_path):
    """``predict`` with previous data from one port checkpoint in both
    packages: ``graph_{mesh id}.xdmf`` on the tetrahedra, the first frame at
    ``2 * dt``, the predictions within ``ROLLOUT_ATOL``."""
    param = _param(*aneurysm)
    ds, jax_ds = _datasets(param)
    val_ds, jax_val = _datasets(param, val=True)
    trainer = Trainer(param, learning_rate=1e-3, warmup=3, device="cpu", metrics_path=None,
                      rollout_dir=None, checkpoint_dir=str(tmp_path / "ckpt"), **_options())
    trainer.fit(GraphLoader(ds, batch_size=2, shuffle=True), num_epochs=1)
    ckpt = str(tmp_path / "ckpt" / "state.pt")
    fresh = Trainer(copy.deepcopy(param), metrics_path=None, rollout_dir=None, device="cpu",
                    **_options())
    fresh.init_state(1)
    load_checkpoint(ckpt, fresh.sim)
    got = fresh.predict(val_ds, save_dir=str(tmp_path / "port"))
    jax_trainer = JaxTrainer(param, metrics_path=None, rollout_dir=None, parallel_validation=False,
                             checkpoint_dir=str(tmp_path / "jax_ckpt"), **_options())
    jax_trainer.init_state(JaxLoader(jax_val, batch_size=1, shuffle=False, prefetch=0).peek(), 1)
    jax_trainer.state = jax_checkpoint.load_checkpoint(ckpt, jax_trainer.state)
    want = jax_trainer.predict(jax_val, save_dir=str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        "graph_0.h5", "graph_0.xdmf", "graph_1.h5", "graph_1.xdmf"]
    dt = val_ds.dt
    for traj, (a, b) in enumerate(zip(got, want)):
        raw = val_ds._load(val_ds.trajectory_indices(traj)[0])
        n = raw.num_nodes
        np.testing.assert_allclose(a[:, :n], np.asarray(b)[:, :n], rtol=0, atol=ROLLOUT_ATOL)
        with JaxReader(str(tmp_path / "port" / f"graph_{traj}.xdmf")) as r, \
                JaxReader(str(tmp_path / "jax" / f"graph_{traj}.xdmf")) as j:
            (cell_type, cells), = r.read_points_cells()[1]
            assert cell_type == "tetra" and cells.shape == raw.tetra.shape
            np.testing.assert_array_equal(cells, j.read_points_cells()[1][0][1])
            np.testing.assert_array_equal(r.read_points_cells()[0], j.read_points_cells()[0])
            assert r.num_steps == j.num_steps == a.shape[0] == STEPS - 2
            for k in range(r.num_steps):
                t, pd, _ = r.read_data(k)
                tj, pj, _ = j.read_data(k)
                assert t == tj and t == pytest.approx((k + 2) * dt)
                np.testing.assert_allclose(pd["prediction"], pj["prediction"], rtol=0,
                                           atol=ROLLOUT_ATOL)

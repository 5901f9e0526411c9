"""Port parity, the transformer serving path end to end: a 6-frame rollout
and its RMSE on a panels trajectory, port (``panels_trajectory`` ->
``stacked_trajectory(layout="csr")`` -> ``rollout`` on the CPU) against the
JAX package (``write_panels_xdmf`` -> ``XDMFDataset(edge_layout="csr")`` ->
``jitted_rollout``, its Pallas kernel in interpret mode), with the JAX
weights and statistics carried across."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.core.graph import stack_graphs as jax_stack_graphs
from graphphysics_tpu.dataset import XDMFDataset
from graphphysics_tpu.models.simulator import Simulator as JaxSim
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.training.rollout import jitted_rollout
from graphphysics_tpu.training.rollout import rollout_rmse as jax_rollout_rmse
from graphphysics_tpu.utils.synthetic import write_panels_xdmf
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.core.graph import round_up
from graphphysics_torch.ops.csr_attention import csr_softmax_spmm
from graphphysics_torch.topology import face_to_edge
from graphphysics_torch.training import (
    build_mask,
    get_preprocessing,
    get_simulator,
    rollout,
    rollout_rmse,
    stacked_trajectory,
)
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from graphphysics_torch.utils.synthetic import panels_trajectory
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# f32, 2 blocks, 6 autoregressive frames fed back into the model
RTOL, ATOL = 1e-4, 1e-4
STEPS, NX, NY = 7, 12, 8
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _param():
    with open(ROOT / "training_config" / "panels.json") as fp:
        param = json.load(fp)
    param["model"].update(message_passing_num=2, hidden_size=32)  # cut to a test size
    return param


def test_panels_rollout_matches_jax(tmp_path):
    folder, meta_path = write_panels_xdmf(str(tmp_path / "panels"), num_traj=1, steps=STEPS,
                                          nx=NX, ny=NY)
    with open(meta_path) as fp:
        meta = json.load(fp)
    traj, mem_meta = panels_trajectory(steps=STEPS, nx=NX, ny=NY, phase0=0.0)
    assert mem_meta == meta
    param = _param()

    n_pad = round_up(traj["mesh_pos"].shape[1], 128)
    e_pad = round_up(int(len(face_to_edge(traj["cells"][0])[0]) * 1.15), 128)
    pre = get_preprocessing(param, use_edge_feature=False, remove_noise=True)
    frames = stacked_trajectory(traj, meta, n_pad, e_pad, node_type_index=3, preprocessing=pre,
                                layout="csr")

    jax_pre = jax_pp.get_preprocessing(param, use_edge_feature=False, remove_noise=True)
    ds = XDMFDataset(folder, meta_path, preprocessing=jax_pre, add_edge_features=False,
                     node_type_index=3, node_budget=n_pad, edge_budget=e_pad, edge_layout="csr")
    items = [ds[i] for i in ds.trajectory_indices(0)]
    jframes = jax.tree_util.tree_map(jnp.asarray, jax_stack_graphs(items))
    assert frames.x.shape == jframes.x.shape == (STEPS - 1, n_pad, 5)
    for field in ("x", "senders", "receivers", "edge_mask", "node_mask", "y"):
        np.testing.assert_allclose(getattr(frames, field), np.asarray(getattr(jframes, field)),
                                   rtol=0, atol=1e-7, err_msg=field)
    assert frames.edge_attr is None and jframes.edge_attr is None

    jax_sim = jax_pp.get_simulator(param)
    with pltpu.force_tpu_interpret_mode():  # init and rollout run the Pallas kernel
        first = jax.tree_util.tree_map(lambda a: a[0], jframes)
        variables = jax_sim.init({"params": jax.random.key(3)}, first)
        for t in range(jframes.x.shape[0]):
            _, mut = jax_sim.apply(
                variables, jax.tree_util.tree_map(lambda a: a[t], jframes),
                method=JaxSim.accumulate_stats, mutable=["normalizer"],
            )
            variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
        want_p, want_t = jitted_rollout(jax_sim, variables, jframes, jax.random.key(0))

    sim = get_simulator(param, device="cpu")
    load_reference_checkpoint(sim, export_reference_checkpoint(variables))
    launches = csr_softmax_spmm.launches
    preds, targets = rollout(sim, frames, device="cpu")
    assert csr_softmax_spmm.launches == launches  # the CPU never launches the kernel
    assert preds.shape == (STEPS - 1, n_pad, 3)
    np.testing.assert_allclose(targets.numpy(), np.asarray(want_t), rtol=0, atol=1e-7)
    np.testing.assert_allclose(preds.numpy(), np.asarray(want_p), rtol=RTOL, atol=ATOL)
    mask = torch.from_numpy(frames.node_mask[0])
    np.testing.assert_allclose(
        rollout_rmse(preds, targets, mask).item(),
        float(jax_rollout_rmse(want_p, want_t, jframes.node_mask[0])), rtol=1e-4,
    )
    # all three output columns are fed back: the third, which the model does
    # not read, accumulates the predicted deltas on free nodes
    free = ~build_mask(torch.from_numpy(frames.x[0, :, 3]).to(torch.int64)) & mask
    assert torch.all(preds[-1, free, 2] != 0)
    assert np.all(traj["VitesseCoarse"][:, :, 2] == 0)

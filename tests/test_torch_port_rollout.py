"""Port parity, serving path: a 6-frame rollout and its RMSE on a
``write_cylinder_h5`` trajectory, port (``read_h5_trajectory`` ->
``stacked_trajectory`` -> ``rollout`` on the CPU) against the JAX package
(``H5Dataset`` -> ``stack_graphs`` -> ``jitted_rollout``), with the JAX
weights and statistics carried across."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from graphphysics_tpu.core.graph import stack_graphs as jax_stack_graphs
from graphphysics_tpu.dataset import H5Dataset
from graphphysics_tpu.dataset.preprocessing import build_preprocessing as jax_build_preprocessing
from graphphysics_tpu.models.simulator import Simulator as JaxSim
from graphphysics_tpu.training.rollout import build_mask as jax_build_mask
from graphphysics_tpu.training.rollout import jitted_rollout
from graphphysics_tpu.training.rollout import rollout_rmse as jax_rollout_rmse
from graphphysics_tpu.utils.synthetic import write_cylinder_h5
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint
from graphphysics_torch.core.graph import round_up
from graphphysics_torch.dataset import build_preprocessing, read_h5_trajectory
from graphphysics_torch.topology import face_to_edge
from graphphysics_torch.training import build_mask, rollout, rollout_rmse, stacked_trajectory
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from graphphysics_torch.utils.synthetic import cylinder_trajectory
from tests._torch_port_common import simulator_pair

# f32, 2 blocks, 6 autoregressive frames fed back into the model
RTOL, ATOL = 1e-4, 1e-4


def test_rollout_matches_jax(tmp_path):
    h5_path, meta_path = write_cylinder_h5(str(tmp_path), num_traj=2, steps=7, nx=12, ny=8)
    with open(meta_path) as fp:
        meta = json.load(fp)

    traj = read_h5_trajectory(h5_path, "1", meta)
    mem_traj, mem_meta = cylinder_trajectory(steps=7, nx=12, ny=8, phase0=0.15)
    assert mem_meta == meta
    for k in traj:
        np.testing.assert_array_equal(traj[k], mem_traj[k], err_msg=k)

    n_pad = round_up(traj["mesh_pos"].shape[1], 128)
    e_pad = round_up(int(len(face_to_edge(traj["cells"][0])[0]) * 1.15), 128)
    frames = stacked_trajectory(traj, meta, n_pad, e_pad, node_type_index=2,
                                preprocessing=build_preprocessing())

    ds = H5Dataset(h5_path, meta_path, preprocessing=jax_build_preprocessing(),
                   node_type_index=2, node_budget=n_pad, edge_budget=e_pad)
    jframes = jax.tree_util.tree_map(
        jnp.asarray, jax_stack_graphs([ds[i] for i in ds.trajectory_indices(1)])
    )
    assert frames.x.shape == jframes.x.shape == (6, n_pad, 4)

    jax_sim, sim = simulator_pair(blocks=2, hidden=16)
    first = jax.tree_util.tree_map(lambda a: a[0], jframes)
    variables = jax_sim.init({"params": jax.random.key(3)}, first)
    for t in range(jframes.x.shape[0]):
        _, mut = jax_sim.apply(
            variables, jax.tree_util.tree_map(lambda a: a[t], jframes),
            method=JaxSim.accumulate_stats, mutable=["normalizer"],
        )
        variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
    want_p, want_t = jitted_rollout(jax_sim, variables, jframes, jax.random.key(0))

    load_reference_checkpoint(sim, export_reference_checkpoint(variables))
    preds, targets = rollout(sim, frames, device="cpu")
    np.testing.assert_allclose(targets.numpy(), np.asarray(want_t), rtol=0, atol=0)
    np.testing.assert_allclose(preds.numpy(), np.asarray(want_p), rtol=RTOL, atol=ATOL)
    mask = torch.from_numpy(frames.node_mask[0])
    np.testing.assert_allclose(
        rollout_rmse(preds, targets, mask).item(),
        float(jax_rollout_rmse(want_p, want_t, jframes.node_mask[0])), rtol=1e-4,
    )
    # boundary nodes are clamped to the targets at every frame
    clamp = build_mask(torch.from_numpy(frames.x[0, :, 2]).to(torch.int64))
    assert torch.equal(preds[:, clamp], targets[:, clamp])


def test_build_mask_matches_jax():
    nt = np.arange(9, dtype=np.int32)
    np.testing.assert_array_equal(
        build_mask(torch.from_numpy(nt)).numpy(), np.asarray(jax_build_mask(jnp.asarray(nt)))
    )

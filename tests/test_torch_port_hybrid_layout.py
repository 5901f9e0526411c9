"""``parallel.mesh.make_hybrid_layout`` against the JAX package's
``make_hybrid_mesh`` (twins of ``tests/test_hybrid_mesh.py``).

A host is a slice: ``torchrun`` gives each host a contiguous block of
ranks, and ranks on one machine emulate the slices as contiguous blocks,
so the port's rank grid must equal the JAX mesh's device-id grid (of the
8 virtual CPU devices, emulated slices) for the same shapes. The 2-D
(data x graph) step runs on a hybrid layout of 4 gloo ranks (the JAX test
takes 8 devices; the port's launches stay at 4 ranks): data across the
emulated hosts, the graph axis inside one; every rank's places are its
grid position, and its two steps' losses finite and equal on every rank."""

import jax
import numpy as np
import pytest

from graphphysics_tpu.parallel import DATA_AXIS, GRAPH_AXIS, make_hybrid_mesh
from graphphysics_torch.parallel import mesh
from graphphysics_torch.parallel.mesh import make_hybrid_layout

from tests import _torch_port_common  # noqa: F401  (thread cap, sync dispatch)
from tests._torch_port_model_parallel_cases import run_cases
from tests._torch_port_partition_cases import graph_of, raw_graph, uniform_parts

LAUNCH_TIMEOUT_S = 180
WORLD = 8


def jax_ids(names, dcn, ici):
    return np.vectorize(lambda d: d.id)(make_hybrid_mesh(names, dcn_shape=dcn,
                                                         ici_shape=ici).devices)


def test_hybrid_layout_graph_axis_stays_on_one_host():
    """With dcn=(2,1) x ici=(2,2) over 8 ranks, every graph-axis group lies
    inside one (emulated, contiguous) host."""
    layout = make_hybrid_layout((DATA_AXIS, GRAPH_AXIS), dcn_shape=(2, 1), ici_shape=(2, 2),
                                world_size=WORLD)
    assert layout.axis_names == (DATA_AXIS, GRAPH_AXIS)
    assert layout.shape == (4, 2)
    per_host = 4
    ids = layout.grid
    assert (ids // per_host == ids[:, :1] // per_host).all()
    assert sorted(ids.ravel().tolist()) == list(range(WORLD))


def test_hybrid_layout_validates_shapes():
    with pytest.raises(ValueError, match="prod"):
        make_hybrid_layout((DATA_AXIS,), dcn_shape=(3,), ici_shape=(2,), world_size=WORLD)
    with pytest.raises(ValueError, match="match axis_names"):
        make_hybrid_layout((DATA_AXIS, GRAPH_AXIS), dcn_shape=(2,), ici_shape=(2, 2),
                           world_size=WORLD)


def test_hybrid_layout_defaults_single_host():
    assert make_hybrid_layout((DATA_AXIS,), world_size=WORLD).shape == (WORLD,)


@pytest.mark.parametrize("names,dcn,ici", [
    ((DATA_AXIS, GRAPH_AXIS), (2, 1), (2, 2)),
    ((DATA_AXIS, GRAPH_AXIS), (1, 2), (4, 1)),   # hosts on the second axis: column-major
    ((DATA_AXIS, GRAPH_AXIS), (2, 2), (1, 2)),
    ((DATA_AXIS, mesh.MODEL_AXIS, mesh.PIPE_AXIS), (2, 1, 1), (1, 2, 2)),
    ((DATA_AXIS,), None, None),
])
def test_hybrid_rank_grid_equals_the_jax_device_grid(names, dcn, ici):
    assert len(jax.devices()) == WORLD
    got = make_hybrid_layout(names, dcn, ici, world_size=WORLD).grid
    np.testing.assert_array_equal(got, jax_ids(names, dcn, ici))


@pytest.mark.parametrize("dcn,ici", [((2, 1), (1, 2)), ((1, 2), (2, 1))])
def test_2d_step_runs_on_hybrid_layout(dcn, ici):
    """The data x graph step runs unchanged on a hybrid layout of 4 ranks
    (dcn=(2,1), ici=(1,2): data across emulated hosts, the graph axis
    within one; and the column-major grid of hosts on the graph axis): each
    rank's (data row, graph column) is its position in the grid, and its
    losses are finite and the same on every rank."""
    layout = make_hybrid_layout((DATA_AXIS, GRAPH_AXIS), dcn_shape=dcn, ici_shape=ici,
                                world_size=4)
    assert layout.shape == (2, 2)
    parts = uniform_parts([graph_of(raw_graph(n=64, seed=s)) for s in (3, 4)], 2,
                          "gather", False)
    case = dict(kind="dp2d", spec=dict(family="epd", blocks=1, hidden=8), parts=parts)
    results = mesh.launch(run_cases, 4, "cpu", args=({"dp2d": case},), timeout=LAUNCH_TIMEOUT_S,
                          threads=1, layout=layout)
    for rank, res in enumerate(r["dp2d"] for r in results):
        d, p = np.argwhere(layout.grid == rank)[0]
        assert res["places"] == (d, p) and res["sizes"] == (2, 2)
        assert np.isfinite(res["losses"]).all()
        assert res["losses"] == results[0]["dp2d"]["losses"]

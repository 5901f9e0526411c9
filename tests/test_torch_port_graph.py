"""Port parity, host side: padding, receiver sorting, concat and stack
(``graphphysics_torch.core.graph``), topology, samples and preprocessing,
the synthetic trajectory and the normalizer formulas, against the JAX
package on the same numpy inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core import graph as jax_graph
from graphphysics_tpu.core import normalizer as jax_norm
from graphphysics_tpu.dataset.h5_dataset import frame_to_sample as jax_frame_to_sample
from graphphysics_tpu.dataset.preprocessing import build_preprocessing as jax_build_preprocessing
from graphphysics_tpu.topology import build as jax_topo
from graphphysics_tpu.utils import synthetic as jax_synth
from graphphysics_torch.core import normalizer as norm
from graphphysics_torch.core.graph import (
    Graph,
    bucket_size,
    concat_graphs,
    pad_graph_np,
    pad_graph_sorted_np,
    round_up,
    stack_graphs,
)
from graphphysics_torch.core.nodetype import NodeType
from graphphysics_torch.dataset import build_preprocessing, frame_to_sample
from graphphysics_torch.ops.segment import masked_segment_sum
from graphphysics_torch.topology import build as topo
from graphphysics_torch.utils import synthetic
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

FIELDS = ("x", "pos", "senders", "receivers", "edge_attr", "node_mask", "edge_mask", "y")


def _raw(seed, n=40, e=130):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    return dict(
        x=x,
        pos=r.normal(size=(n, 2)).astype(np.float32),
        senders=r.integers(0, n, e).astype(np.int32),
        receivers=r.integers(0, n, e).astype(np.int32),
        edge_attr=r.normal(size=(e, 3)).astype(np.float32),
        y=r.normal(size=(n, 2)).astype(np.float32),
    )


def _assert_fields_equal(ours, theirs, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(ours, f)), np.asarray(getattr(theirs, f)), err_msg=f)


def test_nodetype_matches_jax():
    from graphphysics_tpu.core.nodetype import NodeType as JaxNodeType

    assert {m.name: int(m) for m in NodeType} == {m.name: int(m) for m in JaxNodeType}


@pytest.mark.parametrize("n_pad", [40, 48])  # n_pad == n and n_pad > n
def test_pad_graph_np_matches_jax(n_pad):
    raw = _raw(0)
    kw = dict(n_pad=n_pad, e_pad=160, node_type_index=2)
    _assert_fields_equal(pad_graph_np(**raw, **kw), jax_graph.pad_graph_np(**raw, **kw))


@pytest.mark.parametrize("n_pad", [40, 48])
def test_sorted_padding_is_the_sorted_jax_padding(n_pad):
    raw = _raw(1)
    g = pad_graph_sorted_np(**raw, n_pad=n_pad, e_pad=160, node_type_index=2)
    order = np.argsort(raw["receivers"], kind="stable")
    sorted_raw = dict(raw, senders=raw["senders"][order], receivers=raw["receivers"][order],
                      edge_attr=raw["edge_attr"][order])
    _assert_fields_equal(g, jax_graph.pad_graph_np(**sorted_raw, n_pad=n_pad, e_pad=160, node_type_index=2))
    assert np.all(np.diff(g.receivers) >= 0)
    e = len(order)
    for node in range(n_pad):
        lo, hi = g.row_bounds[:, node]
        np.testing.assert_array_equal(np.flatnonzero(g.receivers[:e] == node), np.arange(lo, hi))


def test_sort_keeps_node_aggregates():
    raw = _raw(2)
    plain = pad_graph_np(**raw, n_pad=48, e_pad=160)
    srt = pad_graph_sorted_np(**raw, n_pad=48, e_pad=160)
    h = np.random.default_rng(3).normal(size=(len(raw["senders"]), 6)).astype(np.float32)

    def aggregate(g, rows):
        data = np.zeros((160, 6), np.float32)
        data[: len(rows)] = rows
        return masked_segment_sum(
            torch.from_numpy(data), torch.from_numpy(g.receivers), 48,
            mask=torch.from_numpy(g.edge_mask),
            row_bounds=None if g.row_bounds is None else torch.from_numpy(g.row_bounds),
        ).numpy()

    order = np.argsort(raw["receivers"], kind="stable")
    # f32 sums of the same terms in another order
    np.testing.assert_allclose(aggregate(srt, h[order]), aggregate(plain, h), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sort", [False, True])
def test_concat_and_stack_match_jax(sort):
    pad = pad_graph_sorted_np if sort else pad_graph_np
    raws = [_raw(10 + i, n=30 + i) for i in range(3)]
    ours = [pad(**r, n_pad=40, e_pad=160, node_type_index=2) for r in raws]
    theirs = [jax_graph.pad_graph_np(**(dict(r, **_sorted_edges(r)) if sort else r), n_pad=40,
                                     e_pad=160, node_type_index=2) for r in raws]
    cat = concat_graphs(ours)
    _assert_fields_equal(cat, jax_graph.concat_graphs(theirs))
    _assert_fields_equal(stack_graphs(ours), jax_graph.stack_graphs(theirs))
    if sort:
        assert np.all(np.diff(cat.receivers) >= 0)
        np.testing.assert_array_equal(cat.row_bounds[:, 40:80], ours[1].row_bounds + 160)
        assert stack_graphs(ours).row_bounds.shape == (3, 2, 40)
    else:
        assert cat.row_bounds is None


def _sorted_edges(raw):
    order = np.argsort(raw["receivers"], kind="stable")
    return dict(senders=raw["senders"][order], receivers=raw["receivers"][order],
                edge_attr=raw["edge_attr"][order])


def test_graph_to_cpu_and_indexing():
    g = stack_graphs([pad_graph_sorted_np(**_raw(4), n_pad=48, e_pad=160) for _ in range(2)])
    t = g.to("cpu")
    assert t.x.dtype == torch.float32 and t.receivers.dtype == torch.int32
    assert t.edge_mask.dtype == torch.bool and t.row_bounds.dtype == torch.int32
    assert t[1].x.shape == (48, 4) and t[:1].x.shape == (1, 48, 4)
    assert t.exclude_mask is None and t.num_nodes == 48 and t.num_edges == 160
    assert {f.name for f in dataclasses.fields(Graph)} >= set(FIELDS)


def test_sizes_match_jax():
    for n in (1, 127, 128, 129, 2048, 11906):
        assert round_up(n, 128) == jax_graph.round_up(n, 128)
        for growth in (1.0, 1.25):
            assert bucket_size(n, 128, growth) == jax_graph.bucket_size(n, 128, growth)


def test_topology_matches_jax():
    points, tris = synthetic.triangulated_grid(9, 6)
    jp, jt = jax_synth.triangulated_grid(9, 6)
    np.testing.assert_array_equal(points, jp)
    np.testing.assert_array_equal(tris, jt)
    s, r = topo.face_to_edge(tris)
    js, jr = jax_topo.face_to_edge(jt)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(r, jr)
    cs, cr = topo.cells_to_edges(tris)
    np.testing.assert_array_equal(cs, js)
    np.testing.assert_allclose(
        topo.cartesian_distance_features(points, s, r),
        jax_topo.cartesian_distance_features(jp, js, jr), rtol=1e-6,
    )
    us, ur = topo.to_undirected(np.array([0, 1, 2, 2]), np.array([1, 0, 3, 2]))
    jus, jur = jax_topo.to_undirected(np.array([0, 1, 2, 2]), np.array([1, 0, 3, 2]))
    np.testing.assert_array_equal(us, jus)
    np.testing.assert_array_equal(ur, jur)
    np.testing.assert_array_equal(
        synthetic.cylinder_node_types(points), jax_synth.cylinder_node_types(jp)
    )


def test_frame_to_sample_and_preprocessing_match_jax():
    traj, meta = synthetic.cylinder_trajectory(steps=5, nx=7, ny=5, phase0=0.3)
    rng = np.random.default_rng(0)
    ours = build_preprocessing()(frame_to_sample(traj, 2, meta, frame_target=3), rng)
    theirs = jax_build_preprocessing()(jax_frame_to_sample(traj, 2, meta, frame_target=3), rng)
    for f in ("x", "pos", "y", "senders", "receivers", "edge_attr"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f), err_msg=f)
    assert ours.x.shape[1] == 4  # velocity (2), node_type, time
    np.testing.assert_array_equal(ours.faces, theirs.faces)


def test_normalizer_formulas_match_jax():
    r = np.random.default_rng(5)
    state, jstate = norm.init(3), jax_norm.init(3)
    for i in range(3):
        data = r.normal(size=(20, 3)).astype(np.float32) * (i + 1)
        mask = r.random(20) > 0.3
        state = norm.accumulate(state, torch.from_numpy(data), torch.from_numpy(mask))
        jstate = jax_norm.accumulate(jstate, jnp.asarray(data), jnp.asarray(mask))
    probe = r.normal(size=(7, 3)).astype(np.float32)
    for ours, theirs in (
        (norm.mean(state), jax_norm.mean(jstate)),
        (norm.std_with_epsilon(state), jax_norm.std_with_epsilon(jstate)),
        (norm.normalize(state, torch.from_numpy(probe)), jax_norm.normalize(jstate, jnp.asarray(probe))[1]),
        (norm.inverse(state, torch.from_numpy(probe)), jax_norm.inverse(jstate, jnp.asarray(probe))),
    ):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)
    # zero statistics: the 1e-8 std floor; past MAX_ACCUMULATIONS: no-op
    assert norm.std_with_epsilon(norm.init(2)).tolist() == pytest.approx([1e-8, 1e-8])
    full = dataclasses.replace(norm.init(2), num_accumulations=torch.tensor(float(norm.MAX_ACCUMULATIONS)))
    after = norm.accumulate(full, torch.ones(4, 2))
    assert after.acc_count.item() == 0.0 and after.acc_sum.sum().item() == 0.0

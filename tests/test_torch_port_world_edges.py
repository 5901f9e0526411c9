"""Port parity, the host topology and preprocessing of the DeformingPlate
path and the other edge builders: ``world_pos_features``, ``k_hop_edges``,
``world_edges``, ``add_random_edges``, ``tetra_boundary_faces``,
``min_distance_to_type``, ``add_obstacles_next_pos``, ``add_world_edges``,
``add_world_pos_features``, ``random_3d_rotate`` and the world-position
branch of ``build_preprocessing`` / ``get_preprocessing``, each against the
JAX function on the same numpy inputs and the same generator, bit for bit.
Twins of ``test_preprocessing_extra.py`` (all of it) and of
``test_dataset.py::test_add_obstacles_next_pos_preserves_prefix_columns``."""

import json
import math
import pathlib

import numpy as np
import pytest

from graphphysics_tpu import topology as jax_topology
from graphphysics_tpu.dataset import preprocessing as jax_pre
from graphphysics_tpu.dataset.sample import RawSample as JaxRawSample
from graphphysics_tpu.external.bezier import add_bezier_node_type as jax_bezier
from graphphysics_tpu.training import parse_parameters as jax_pp
from graphphysics_tpu.utils.synthetic import tet_box as jax_tet_box
from graphphysics_torch import topology
from graphphysics_torch.core import NodeType
from graphphysics_torch.dataset import (
    RawSample,
    add_noise,
    add_obstacles_next_pos,
    add_world_edges,
    add_world_pos_features,
    build_preprocessing,
    random_3d_rotate,
)
from graphphysics_torch.external import add_bezier_node_type
from graphphysics_torch.topology import min_distance_to_type
from graphphysics_torch.training import get_preprocessing
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _mesh(seed, n=60):
    """A random edge list over ``n`` nodes with repeated pairs and self loops."""
    r = np.random.default_rng(seed)
    s = r.integers(0, n, 4 * n).astype(np.int32)
    recv = r.integers(0, n, 4 * n).astype(np.int32)
    return s, recv, r


def _assert_pairs_equal(ours, theirs):
    for a, b in zip(ours, theirs):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_to_undirected_and_unique_pairs_match_jax(seed):
    s, r, _ = _mesh(seed)
    _assert_pairs_equal(topology.to_undirected(s, r), jax_topology.to_undirected(s, r))
    pairs = np.unique(np.stack([s, r], axis=1), axis=0)
    _assert_pairs_equal(topology.unique_pairs(s, r),
                        (pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)))


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_k_hop_edges_match_jax(hops):
    points, tets = jax_tet_box(4, 3, 3)
    s, r = topology.cells_to_edges(tets)
    ours = topology.k_hop_edges(s, r, len(points), hops)
    _assert_pairs_equal(ours, jax_topology.k_hop_edges(s, r, len(points), hops))
    if hops > 1:
        assert len(ours[0]) > len(s)
        assert not np.any(ours[0] == ours[1])


@pytest.mark.parametrize("radius", [0.0, 0.3, 0.8])
def test_world_edges_match_jax(radius):
    r = np.random.default_rng(3)
    pos = r.uniform(size=(80, 3)).astype(np.float32)
    nt = r.choice([NodeType.NORMAL, NodeType.OBSTACLE, NodeType.HANDLE], size=80).astype(np.float32)
    ours = topology.world_edges(pos, nt, radius, int(NodeType.OBSTACLE), int(NodeType.NORMAL))
    theirs = jax_topology.world_edges(pos, nt, radius, int(NodeType.OBSTACLE), int(NodeType.NORMAL))
    _assert_pairs_equal(ours, theirs)
    kinds = {frozenset((nt[a], nt[b])) for a, b in zip(*ours)}
    assert kinds <= {frozenset((float(NodeType.OBSTACLE), float(NodeType.NORMAL)))}
    assert (len(ours[0]) > 0) == (radius > 0)


@pytest.mark.parametrize("ratio", [0.0, 0.001, 0.2, 1.0, 1.5])
def test_add_random_edges_match_jax(ratio):
    s, r, _ = _mesh(4)
    s, r = topology.to_undirected(s, r)
    ours = topology.add_random_edges(s, r, 60, ratio, np.random.default_rng(9))
    theirs = jax_topology.add_random_edges(s, r, 60, ratio, np.random.default_rng(9))
    _assert_pairs_equal(ours, theirs)
    grew = 0 < ratio <= 1 and round(ratio * len(s) / 2) > 0
    assert (len(ours[0]) > len(s)) == grew


def test_world_pos_features_match_jax():
    s, r, rng = _mesh(5)
    wp = rng.normal(size=(60, 3)).astype(np.float32)
    existing = rng.normal(size=(len(s), 4)).astype(np.float32)
    ours = topology.world_pos_features(wp, s, r, existing)
    np.testing.assert_array_equal(ours, jax_topology.world_pos_features(wp, s, r, existing))
    assert ours.shape == (len(s), 8) and ours.dtype == np.float32


def test_tetra_boundary_faces_match_jax():
    _, tets = jax_tet_box(3, 4, 3)
    ours = topology.tetra_boundary_faces(tets)
    np.testing.assert_array_equal(ours, jax_topology.tetra_boundary_faces(tets))
    # a box of 2 x 3 x 2 cubes: two triangles per boundary square
    assert len(ours) == 2 * 2 * (2 * 3 + 3 * 2 + 2 * 2)


def test_min_distance_to_type():
    """Twin of ``test_preprocessing_extra.py::test_min_distance_to_type``,
    and against the JAX function on random points."""
    pos = np.array([[0, 0], [1, 0], [3, 0]], np.float32)
    nt = np.array([NodeType.WALL_BOUNDARY, NodeType.NORMAL, NodeType.NORMAL])
    d = min_distance_to_type(pos, nt, int(NodeType.WALL_BOUNDARY))
    np.testing.assert_allclose(d, [0.0, 1.0, 3.0], rtol=1e-6)
    r = np.random.default_rng(6)
    pos = r.normal(size=(50, 3)).astype(np.float32)
    nt = r.integers(0, 3, 50)
    for target in (1, 9):
        np.testing.assert_array_equal(min_distance_to_type(pos, nt, target),
                                      jax_topology.min_distance_to_type(pos, nt, target))


def _sample3d(rng, n=40, cls=RawSample):
    x = rng.normal(size=(n, 8)).astype(np.float32)
    x[:, 6] = 0  # node type col
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    y = rng.normal(size=(n, 3)).astype(np.float32)
    return cls(x=x, pos=pos, y=y)


def test_random_3d_rotate_preserves_norms():
    rng = np.random.default_rng(0)
    s = _sample3d(rng)
    pos0, y0, feat0 = s.pos.copy(), s.y.copy(), s.x[:, 0:3].copy()
    out = random_3d_rotate(s, rng, feature_indices=[(0, 3)])
    np.testing.assert_allclose(np.linalg.norm(out.pos, axis=1), np.linalg.norm(pos0, axis=1),
                               rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(out.x[:, 0:3], axis=1),
                               np.linalg.norm(feat0, axis=1), rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(out.y[:, 0:3], axis=1), np.linalg.norm(y0, axis=1),
                               rtol=1e-4)
    assert np.abs(out.pos - pos0).max() > 1e-3


def test_random_3d_rotate_matches_jax():
    """The same generator draws the same angles and the same matrix."""
    ours = random_3d_rotate(_sample3d(np.random.default_rng(1)), np.random.default_rng(2),
                            feature_indices=[(0, 3), (3, 6)])
    theirs = jax_pre.random_3d_rotate(_sample3d(np.random.default_rng(1), cls=JaxRawSample),
                                      np.random.default_rng(2), feature_indices=[(0, 3), (3, 6)])
    for f in ("x", "pos", "y"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    with pytest.raises(ValueError, match="3 columns"):
        random_3d_rotate(_sample3d(np.random.default_rng(1)), None, feature_indices=[(0, 2)])


def test_fixed_3d_rotate_matches_reference_convention():
    """90 degrees around z with the reference's matrix layout: row vectors
    times ``[[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]]``."""
    rng = np.random.default_rng(3)
    s = _sample3d(rng)
    pos0, y0, feat0 = s.pos.copy(), s.y.copy(), s.x[:, 0:3].copy()
    out = random_3d_rotate(s, rng, feature_indices=[(0, 3)], angles=(math.pi / 2, 0.0, 0.0))
    m = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    np.testing.assert_allclose(out.pos, pos0 @ m, atol=1e-6)
    np.testing.assert_allclose(out.x[:, 0:3], feat0 @ m, atol=1e-6)
    np.testing.assert_allclose(out.y[:, 0:3], y0[:, 0:3] @ m, atol=1e-6)


def test_noise_curriculum_scale():
    rng = np.random.default_rng(4)
    n = 2000
    x = np.zeros((n, 4), np.float32)
    out = add_noise(RawSample(x=x.copy(), pos=np.zeros((n, 2), np.float32)), rng, [0], [2], 0.1,
                    node_type_index=2, t=1.0)
    assert np.abs(out.x[:, 0:2]).max() == 0.0  # t=1: 10*0.1*(1+cos(pi)) = 0
    out2 = add_noise(RawSample(x=x.copy(), pos=np.zeros((n, 2), np.float32)), rng, [0], [2], 0.1,
                     node_type_index=2, t=0.0)
    assert abs(out2.x[:, 0:2].std() - 2.0) < 0.1  # t=0: 10*0.1*2 = 2


def test_bezier_node_type_hook():
    """Twin of ``test_preprocessing_extra.py::test_bezier_node_type_hook``:
    the node type from the one-hot boundary columns 3..7, appended, equal
    to the JAX hook's."""
    rng = np.random.default_rng(5)
    x = np.zeros((6, 8), np.float32)
    x[:, 0:3] = rng.normal(size=(6, 3))
    x[1, 3] = 1.0  # bn only -> WALL
    x[2, 4] = 1.0  # a1 -> INFLOW
    x[3, 6] = 1.0  # a3 -> OUTFLOW
    x[4, 3] = x[4, 5] = 1.0  # bn with a2 -> NORMAL
    x[5, 4] = x[5, 6] = 1.0  # a1 and a3 -> OUTFLOW
    pos = rng.normal(size=(6, 2)).astype(np.float32)
    out = add_bezier_node_type(RawSample(x=x.copy(), pos=pos), rng)
    expected = [NodeType.NORMAL, NodeType.WALL_BOUNDARY, NodeType.INFLOW, NodeType.OUTFLOW,
                NodeType.NORMAL, NodeType.OUTFLOW]
    np.testing.assert_array_equal(out.x[:, 8], [float(t) for t in expected])
    np.testing.assert_array_equal(out.x, jax_bezier(JaxRawSample(x=x.copy(), pos=pos), rng).x)


def _plate_sample(cls, seed=0, prefix=0):
    """A raw press-like sample: ``prefix`` leading columns, world position,
    node type (2 obstacles) and time; its target the moved world position
    (with the prefix)."""
    r = np.random.default_rng(seed)
    n = 12
    wp = r.uniform(size=(n, 3)).astype(np.float32)
    nt = np.full((n, 1), float(NodeType.NORMAL), np.float32)
    nt[:3] = float(NodeType.OBSTACLE)
    nt[3:5] = float(NodeType.HANDLE)
    pre = r.normal(size=(n, prefix)).astype(np.float32)
    x = np.concatenate([pre, wp, nt, np.zeros((n, 1), np.float32)], axis=1)
    y = np.concatenate([pre, wp + r.normal(scale=0.05, size=(n, 3)).astype(np.float32)], axis=1)
    faces = np.stack([np.arange(n - 2), np.arange(1, n - 1), np.arange(2, n)], 1)
    return cls(x=x, pos=wp.copy(), faces=faces.astype(np.int64), y=y)


@pytest.mark.parametrize("prefix", [0, 2])
def test_world_steps_match_jax(prefix):
    """``add_obstacles_next_pos``, FaceToEdge, ``add_world_edges``, the
    edge features and ``add_world_pos_features`` in turn, each equal to the
    JAX step's output."""
    from graphphysics_torch.dataset.preprocessing import add_edge_features, apply_face_to_edge

    wps, wpe, nti = prefix, prefix + 3, prefix + 6
    ours, theirs = _plate_sample(RawSample, prefix=prefix), _plate_sample(JaxRawSample, prefix=prefix)
    steps = [
        (lambda s: add_obstacles_next_pos(s, None, wps, wpe, nti),
         lambda s: jax_pre.add_obstacles_next_pos(s, None, wps, wpe, nti)),
        (lambda s: apply_face_to_edge(s, None), lambda s: jax_pre.apply_face_to_edge(s, None)),
        (lambda s: add_world_edges(s, None, wps, wpe, nti, radius=0.4),
         lambda s: jax_pre.add_world_edges(s, None, wps, wpe, nti, radius=0.4)),
        (lambda s: add_edge_features(s, None), lambda s: jax_pre.add_edge_features(s, None)),
        (lambda s: add_world_pos_features(s, None, wps, wpe),
         lambda s: jax_pre.add_world_pos_features(s, None, wps, wpe)),
    ]
    mesh_edges = None
    for ours_step, theirs_step in steps:
        ours, theirs = ours_step(ours), theirs_step(theirs)
        for f in ("x", "senders", "receivers", "edge_attr"):
            a, b = getattr(ours, f), getattr(theirs, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        if mesh_edges is None and ours.senders is not None:
            mesh_edges = len(ours.senders)
    assert ours.x.shape[1] == prefix + 8 and ours.edge_attr.shape[1] == 8
    assert len(ours.senders) > mesh_edges  # world edges were added


def test_add_obstacles_next_pos_preserves_prefix_columns():
    """World position not at column 0: the columns before it survive, and
    the node type is read from its pre-insertion column."""
    n = 6
    rng = np.random.default_rng(0)
    vel = rng.normal(size=(n, 2)).astype(np.float32)
    wp = rng.normal(size=(n, 3)).astype(np.float32)
    nt = np.zeros((n, 1), np.float32)
    nt[:2] = NodeType.OBSTACLE
    x = np.concatenate([vel, wp, nt], axis=1)  # [vel(2), world_pos(3), node_type]
    y = rng.normal(size=(n, 5)).astype(np.float32)
    s = RawSample(x=x.copy(), pos=np.zeros((n, 2), np.float32), faces=np.zeros((1, 3), np.int64),
                  y=y.copy())
    out = add_obstacles_next_pos(s, rng, world_pos_index_start=2, world_pos_index_end=5,
                                 node_type_index=8)
    assert out.x.shape[1] == 9
    np.testing.assert_array_equal(out.x[:, :2], vel)
    np.testing.assert_array_equal(out.x[:, 2:5], wp)
    np.testing.assert_array_equal(out.x[:, 8], nt[:, 0])
    disp = out.x[:, 5:8]
    np.testing.assert_allclose(disp[:2], y[:2, 2:5] - wp[:2], rtol=1e-6)
    np.testing.assert_allclose(disp[2:], np.broadcast_to((y[:2, 2:5] - wp[:2]).mean(0), (n - 2, 3)),
                               rtol=1e-5)


def _plate_config(radius=None):
    param = json.loads((ROOT / "training_config" / "plate.json").read_text())
    if radius is not None:
        param["transformations"]["world_pos_parameters"]["radius"] = radius
    return param


def _names(pipeline):
    return [getattr(s, "func", s).__name__ for s in pipeline.steps]


@pytest.mark.parametrize("remove_noise", [False, True])
@pytest.mark.parametrize("radius", [None, 0.08])
def test_plate_preprocessing_matches_jax(remove_noise, radius):
    """``training_config/plate.json``'s pipeline: the JAX step order (noise
    at position 1, after the obstacles' displacement), the same keywords
    (the default radius 0.03 unless the config gives one), and the same
    processed sample from the same generator."""
    param = _plate_config(radius)
    ours = get_preprocessing(param, use_edge_feature=False, remove_noise=remove_noise)
    theirs = jax_pp.get_preprocessing(param, use_edge_feature=False, remove_noise=remove_noise)
    names = ["add_obstacles_next_pos", "apply_face_to_edge", "add_world_edges",
             "add_edge_features", "add_world_pos_features"]
    if not remove_noise:
        names.insert(1, "add_noise")
    assert _names(ours) == _names(theirs) == names
    for a, b in zip(ours.steps, theirs.steps):
        assert getattr(a, "keywords", None) == getattr(b, "keywords", None)
    world = ours.steps[names.index("add_world_edges")]
    assert world.keywords["radius"] == (0.03 if radius is None else radius)
    got = ours(_plate_sample(RawSample), np.random.default_rng(8))
    want = theirs(_plate_sample(JaxRawSample), np.random.default_rng(8))
    for f in ("x", "senders", "receivers", "edge_attr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_extra_edge_features_come_last():
    def tag(sample, rng):
        sample.edge_attr = np.concatenate([sample.edge_attr, np.ones((len(sample.senders), 1),
                                                                      np.float32)], axis=1)
        return sample

    noise = {"noise_index_start": 0, "noise_index_end": 2, "noise_scale": 0.1, "node_type_index": 2}
    ours = build_preprocessing(noise_parameters=noise, extra_edge_features=tag)
    theirs = jax_pre.build_preprocessing(noise_parameters=noise, extra_edge_features=tag)
    assert _names(ours) == _names(theirs) == ["apply_face_to_edge", "add_noise",
                                              "add_edge_features", "tag"]

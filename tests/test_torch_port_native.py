"""Port twin of ``tests/test_native.py`` (``graphphysics_torch/native``):
the host C++ graph builders that the port's ``face_to_edge``,
``k_hop_edges`` and ``build_ell`` run give, bit for bit and dtype for
dtype, what their plain numpy versions and the JAX package's functions
give, on the cases ``test_native.py`` covers and on more (tetrahedral
faces, degenerate and empty faces, k = 1, directed lists with repeats and
self loops, shuffled and repeated ELL edges, the two error codes). Nothing
here skips: ``g++`` is built and run. The build itself, with a stand-in
compiler, is bounded by its timeout and raises with the compiler's
output."""

import numpy as np
import pytest

from graphphysics_torch import native
from graphphysics_torch.topology import build as port_build
from graphphysics_torch.topology import ell as port_ell
from graphphysics_torch.utils.synthetic import tet_grid, triangulated_grid
from graphphysics_tpu.topology import build as jax_build
from graphphysics_tpu.topology import ell as jax_ell
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)


def _assert_same(*results):
    """Every result the same arrays, bit for bit, with the same dtypes."""
    first = results[0]
    for other in results[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def _grid_edges(nx, ny):
    return port_build.face_to_edge_reference(triangulated_grid(nx, ny)[1])


def _faces(case):
    if case == "triangles":
        return triangulated_grid(20, 15)[1]
    if case == "tetrahedra":
        return port_build.tetra_to_faces(tet_grid(6)[1])
    if case == "repeated_vertex":
        faces = triangulated_grid(7, 5)[1].copy()
        faces[::3, 2] = faces[::3, 0]  # degenerate triangles: one side is a self loop
        faces[1::5] = faces[1::5, [0, 0, 0]]  # every side a self loop
        return faces
    if case == "int64_shuffled":
        faces = triangulated_grid(9, 9)[1].astype(np.int64)
        return faces[np.random.default_rng(0).permutation(len(faces))]
    return np.zeros((0, 3), np.int32)


@pytest.mark.parametrize("case", ["triangles", "tetrahedra", "repeated_vertex", "int64_shuffled",
                                  "empty"])
def test_face_to_edge_matches_plain_and_jax(case):
    faces = _faces(case)
    if len(faces):
        num_nodes = int(faces.max()) + 1
        _assert_same(native.face_to_edge_native(faces, num_nodes),
                     port_build.face_to_edge_reference(faces))
    _assert_same(port_build.face_to_edge(faces), port_build.face_to_edge_reference(faces),
                 jax_build.face_to_edge(faces))


def _directed(seed=0, n=60, e=400):
    """A directed list with repeated edges and self loops."""
    r = np.random.default_rng(seed)
    s, t = r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32)
    return np.concatenate([s, s[:20], [3, 3]]), np.concatenate([t, t[:20], [3, 7]]), n


@pytest.mark.parametrize("graph", ["mesh", "directed"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_k_hop_edges_matches_plain_and_jax(graph, k):
    if graph == "mesh":
        s, r = _grid_edges(12, 10)
        n = int(max(s.max(), r.max())) + 1
    else:
        s, r, n = _directed()
    got = port_build.k_hop_edges(s, r, n, k)
    _assert_same(got, port_build.k_hop_edges_reference(s, r, n, k), jax_build.k_hop_edges(s, r, n, k))
    if k > 1:
        _assert_same(native.k_hop_native(s, r, n, k), got)
        assert not np.any(got[0] == got[1])  # no self loops


def test_k_hop_of_isolated_nodes_is_empty():
    s = r = np.zeros(0, np.int32)
    _assert_same(port_build.k_hop_edges(s, r, 5, 2), port_build.k_hop_edges_reference(s, r, 5, 2),
                 jax_build.k_hop_edges(s, r, 5, 2))


def _ell_edges(case):
    s, r = _grid_edges(10, 8)
    if case == "shuffled_repeats":
        order = np.random.default_rng(1).permutation(len(s))
        s, r = s[order], r[order]
        s, r = np.concatenate([s, s[:9], r[:9]]), np.concatenate([r, r[:9], s[:9]])
    return s, r, int(max(s.max(), r.max())) + 1


@pytest.mark.parametrize("case", ["sorted", "shuffled_repeats"])
@pytest.mark.parametrize("degree", [None, 8, 11])
def test_build_ell_matches_plain_and_jax(case, degree):
    s, r, n = _ell_edges(case)
    got = port_ell.build_ell(s, r, n, degree=degree)
    _assert_same(got, port_ell.build_ell_reference(s, r, n, degree=degree),
                 jax_ell.build_ell(s, r, n, degree=degree))
    _assert_same(native.build_ell_native(s, r, n, got.degree),
                 (got.senders, got.edge_mask, got.edge_perm, got.twin_perm))


def _message(fn, *args, **kwargs):
    with pytest.raises(ValueError) as info:
        fn(*args, **kwargs)
    return str(info.value)


def test_build_ell_error_codes_raise_the_plain_messages():
    # degree overflow: the check before the call, and the C++'s -1
    s = np.array([0, 1, 2, 1, 2, 0], np.int64)
    r = np.array([1, 0, 1, 2, 0, 2], np.int64)
    want = _message(port_ell.build_ell_reference, s, r, 3, degree=1)
    assert want == "max in-degree 2 exceeds ELL degree 1"
    assert _message(port_ell.build_ell, s, r, 3, degree=1) == want
    assert _message(native.build_ell_native, s, r, 3, 1) == want
    assert "exceeds" in _message(jax_ell.build_ell, s, r, 3, degree=1)
    # asymmetry: the C++'s -2
    s, r = np.array([0, 1, 2], np.int64), np.array([1, 0, 1], np.int64)
    want = _message(port_ell.build_ell_reference, s, r, 3, degree=4)
    assert want == "edge list is not symmetric: 1 edges have no reverse twin"
    assert _message(port_ell.build_ell, s, r, 3, degree=4) == want
    assert "not symmetric" in _message(jax_ell.build_ell, s, r, 3, degree=4)


def test_ids_outside_the_nodes_raise():
    with pytest.raises(ValueError, match="outside"):
        native.face_to_edge_native(np.array([[0, 1, 5]]), 4)
    with pytest.raises(ValueError, match="outside"):
        native.k_hop_native(np.array([0, -1]), np.array([1, 0]), 3, 2)
    with pytest.raises(ValueError, match="outside"):
        native.build_ell_native(np.array([0, 3]), np.array([3, 0]), 3, 4)
    with pytest.raises(TypeError, match="integers"):
        native.face_to_edge_native(np.zeros((1, 3), np.float32), 3)


def _fake_gxx(tmp_path, monkeypatch, body):
    from graphphysics_torch.ops import _native

    gxx = tmp_path / "g++"
    gxx.write_text(f"#!/bin/sh\n{body}\n")
    gxx.chmod(0o755)
    monkeypatch.setattr(native, "gxx_path", lambda: str(gxx))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    return native


def test_build_is_bounded_by_its_timeout(tmp_path, monkeypatch):
    lib = _fake_gxx(tmp_path, monkeypatch, "echo compiling; exec sleep 30")
    with pytest.raises(RuntimeError, match="did not finish within") as info:
        lib.build(timeout=0.5)
    assert "compiling" in str(info.value)  # the compiler's output comes with the error
    assert list((tmp_path / "build").iterdir()) == []  # no library, log or partial file left


def test_build_reports_compiler_errors(tmp_path, monkeypatch):
    lib = _fake_gxx(tmp_path, monkeypatch, "echo 'error: no such thing'; exit 1")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for graph_native.cpp") as info:
        lib.build()
    assert "error: no such thing" in str(info.value)
    assert list((tmp_path / "build").iterdir()) == []


def test_build_names_the_library_by_its_source_and_reuses_it(tmp_path, monkeypatch):
    lib = _fake_gxx(tmp_path, monkeypatch,
                    'while [ "$1" != "-o" ]; do shift; done\necho built > "$2"')
    path = lib.library_path()
    assert path.parent == tmp_path / "build" and path.name.startswith("libgraph_native-")
    assert lib.build() > 0
    assert [p.name for p in (tmp_path / "build").iterdir()] == [path.name]
    assert lib.build() == 0.0  # reused


def test_loader_workers_look_in_the_parents_build_directory(tmp_path, monkeypatch):
    import torch

    from graphphysics_torch.dataset import loader
    from graphphysics_torch.ops import _native

    monkeypatch.setattr(_native, "BUILD_DIR", _native.BUILD_DIR)  # restored after the test
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    threads = torch.get_num_threads()
    try:
        loader.init_worker(0, build_dir=str(tmp_path / "cache"))
    finally:
        torch.set_num_threads(threads)
    assert native.library_path().parent == tmp_path / "cache"

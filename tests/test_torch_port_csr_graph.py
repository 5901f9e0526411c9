"""Port parity, the sender-sorted (CSR) layout of the attention kernel:
``pad_graph_csr_np`` and ``concat_graphs`` against the JAX package's, and
``sender_bounds`` kept apart from the receiver-sorted ``row_bounds``."""

import numpy as np
import pytest
import torch

from graphphysics_tpu.core import graph as jax_graph
from graphphysics_torch.core.graph import (
    concat_graphs,
    pad_graph_csr_np,
    pad_graph_sorted_np,
    stack_graphs,
)
from graphphysics_torch.ops.csr_attention import BLOCK_NODES
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)


def _raw(n, e, seed, hi=None):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 5)).astype(np.float32)
    x[:, 3] = r.integers(0, 7, n)
    return (
        x,
        r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n if hi is None else hi, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32),
    )


def _block_view(sender_bounds, num_nodes):
    """The JAX kernel's per-block ranges, read off the per-node ones."""
    return np.stack(
        [sender_bounds[0, ::BLOCK_NODES], sender_bounds[1, BLOCK_NODES - 1 :: BLOCK_NODES]]
    )


@pytest.mark.parametrize(
    "n,e,n_pad,e_pad,hi",
    [(300, 1700, 384, 2048, None), (256, 1500, 256, 1664, None), (500, 900, 512, 1024, 20)],
)
def test_pad_graph_csr_matches_jax(n, e, n_pad, e_pad, hi):
    x, pos, s, r = _raw(n, e, seed=n + e, hi=hi)
    ea = np.random.default_rng(1).normal(size=(e, 3)).astype(np.float32)
    y = np.random.default_rng(2).normal(size=(n, 3)).astype(np.float32)
    got = pad_graph_csr_np(x, pos, s, r, n_pad, e_pad, edge_attr=ea, y=y, node_type_index=3)
    want = jax_graph.pad_graph_csr_np(x, pos, s, r, n_pad, e_pad, edge_attr=ea, y=y,
                                      node_type_index=3)
    for field in ("x", "pos", "senders", "receivers", "edge_attr", "node_mask", "edge_mask", "y"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)), field)
    # the edge permutation is the stable sort by sender; padding follows it
    order = np.argsort(s, kind="stable")
    np.testing.assert_array_equal(got.receivers[:e], r[order])
    assert np.all(np.diff(got.senders) >= 0) and np.all(got.senders[e:] == n_pad - 1)
    assert got.row_bounds is None
    sb = got.sender_bounds
    assert sb.shape == (2, n_pad) and sb.dtype == np.int32
    np.testing.assert_array_equal(_block_view(sb, n_pad), np.asarray(want.csr_bounds))
    # every real edge lies in its sender's range, no range reaches the padding
    idx = np.arange(e)
    assert np.all((sb[0, got.senders[:e]] <= idx) & (idx < sb[1, got.senders[:e]]))
    assert sb.max() <= e


def test_pad_graph_csr_needs_whole_node_blocks():
    x, pos, s, r = _raw(100, 400, seed=0)
    with pytest.raises(ValueError, match="multiple of 128"):
        pad_graph_csr_np(x, pos, s, r, 200, 512)


def test_concat_carries_sender_bounds_as_jax():
    graphs, jgraphs = [], []
    for i, (n, e) in enumerate([(256, 1500), (200, 1200), (250, 0), (256, 1664)]):
        x, pos, s, r = _raw(n, e, seed=10 + i)
        graphs.append(pad_graph_csr_np(x, pos, s, r, 256, 1664, node_type_index=3))
        jgraphs.append(jax_graph.pad_graph_csr_np(x, pos, s, r, 256, 1664, node_type_index=3))
    got = concat_graphs(graphs)
    want = jax_graph.concat_graphs(jgraphs)
    for field in ("senders", "receivers", "edge_mask", "node_mask", "x"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)), field)
    np.testing.assert_array_equal(_block_view(got.sender_bounds, 1024), np.asarray(want.csr_bounds))
    assert np.all(np.diff(got.senders) >= 0) and got.row_bounds is None
    idx = np.arange(got.num_edges)[got.edge_mask]
    seg = got.senders[got.edge_mask]
    assert np.all((got.sender_bounds[0, seg] <= idx) & (idx < got.sender_bounds[1, seg]))


def test_layouts_do_not_mix():
    x, pos, s, r = _raw(128, 500, seed=3)
    csr = pad_graph_csr_np(x, pos, s, r, 128, 512)
    srt = pad_graph_sorted_np(x, pos, s, r, 128, 512)
    assert srt.sender_bounds is None and srt.row_bounds is not None
    with pytest.raises(ValueError, match="some graphs have"):
        concat_graphs([csr, srt])


def test_stack_index_and_move_keep_sender_bounds():
    frames = []
    for i in range(3):
        x, pos, s, r = _raw(128, 500, seed=20 + i)
        frames.append(pad_graph_csr_np(x, pos, s, r, 128, 512))
    stacked = stack_graphs(frames)
    assert stacked.sender_bounds.shape == (3, 2, 128)
    moved = stacked.to("cpu")[1]
    assert moved.sender_bounds.dtype == torch.int32
    np.testing.assert_array_equal(moved.sender_bounds.numpy(), frames[1].sender_bounds)

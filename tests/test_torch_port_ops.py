"""Port parity, ops: the segment sum's plain version and host helpers
(``graphphysics_torch.ops``) against the JAX package's Pallas kernel (in
interpret mode), its host helpers and ``masked_segment_sum``. Inputs come
from numpy with a seed and go to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.ops import pallas_segment as jax_ps
from graphphysics_tpu.ops import segment as jax_seg
from graphphysics_torch.core.graph import pad_graph_sorted_np
from graphphysics_torch.ops.csr_segment import (
    compute_block_offsets,
    compute_max_chunks,
    compute_row_bounds,
    csr_segment_sum,
    csr_segment_sum_reference,
)
from graphphysics_torch.ops.segment import masked_segment_sum, take_rows
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# f32 sums of the same terms in another order (the tolerance of
# tests/test_pallas_segment.py)
RTOL, ATOL = 1e-5, 1e-4


def _sorted_case(n, e, h, seed, hi=None):
    r = np.random.default_rng(seed)
    recv = np.sort(r.integers(0, n if hi is None else hi, e)).astype(np.int32)
    data = r.normal(size=(e, h)).astype(np.float32)
    return data, recv


@pytest.mark.parametrize(
    "n,e,h,hi",
    [(1024, 4096, 128, None), (512, 1000, 128, None), (300, 2048, 128, None),
     (1024, 4096, 64, 8)],  # the last: all edges into 8 nodes (skewed)
)
def test_csr_segment_sum_matches_pallas_kernel(n, e, h, hi):
    data, recv = _sorted_case(n, e, h, seed=n + e, hi=hi)
    offsets = jax_ps.compute_block_offsets(recv, n)
    with pltpu.force_tpu_interpret_mode():
        want = jax_ps.csr_segment_sum(
            jnp.asarray(data), jnp.asarray(recv), jnp.asarray(offsets), n,
            max_chunks=jax_ps.compute_max_chunks(offsets),
        )
    got = csr_segment_sum(
        torch.from_numpy(data), torch.from_numpy(recv),
        torch.from_numpy(compute_row_bounds(recv, n)),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-3 if hi else ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_helpers_match_jax(seed):
    r = np.random.default_rng(seed)
    n = int(r.integers(100, 3000))
    recv = np.sort(r.integers(0, n, int(r.integers(10, 9000)))).astype(np.int32)
    for bn in (128, 256):
        ours = compute_block_offsets(recv, n, block_nodes=bn)
        theirs = jax_ps.compute_block_offsets(recv, n, block_nodes=bn)
        np.testing.assert_array_equal(ours, theirs)
        for be in (256, 512):
            assert compute_max_chunks(ours, be) == jax_ps.compute_max_chunks(theirs, be)


def test_row_bounds_cover_exactly_the_real_edges():
    recv = np.array([0, 0, 2, 2, 2, 5, 6, 6, 6], np.int32)  # last 2 are padding
    b = compute_row_bounds(recv, 7, num_real_edges=7)
    np.testing.assert_array_equal(b[0], [0, 2, 2, 5, 5, 5, 6])
    np.testing.assert_array_equal(b[1], [2, 2, 5, 5, 5, 6, 7])
    with pytest.raises(ValueError):
        compute_row_bounds(np.array([1, 0], np.int32), 2)


def _padded_last_node_real(seed=3, n=40, e=150, e_pad=192, h=16):
    """A receiver-sorted graph with n_pad == n: padded edges are self-loops
    on a REAL node; their data rows are nonzero, so a leak shows there."""
    r = np.random.default_rng(seed)
    recv = r.integers(0, n, e).astype(np.int32)
    recv[:5] = n - 1  # the last node also has real edges
    g = pad_graph_sorted_np(
        np.zeros((n, 3), np.float32), np.zeros((n, 2), np.float32),
        r.integers(0, n, e).astype(np.int32), recv, n_pad=n, e_pad=e_pad,
    )
    data = r.normal(size=(e_pad, h)).astype(np.float32)
    return g, data


def test_masked_padding_with_real_last_node():
    g, data = _padded_last_node_real()
    n = g.num_nodes
    want = jax_seg.masked_segment_sum(
        jnp.asarray(data), jnp.asarray(g.receivers), n, mask=jnp.asarray(g.edge_mask)
    )
    t = {k: torch.from_numpy(getattr(g, k)) for k in ("receivers", "row_bounds", "edge_mask")}
    got = csr_segment_sum(torch.from_numpy(data), t["receivers"], t["row_bounds"], t["edge_mask"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # brute force over the row ranges: what the CUDA kernel reads
    rb = g.row_bounds
    brute = np.stack([data[rb[0, i]:rb[1, i]].sum(0) for i in range(n)])
    np.testing.assert_allclose(got.numpy(), brute, rtol=RTOL, atol=ATOL)
    # the padded edges lie outside every range: unmasked, they break the
    # kernel's precondition, which the CPU path checks
    with pytest.raises(ValueError, match="outside its receiver's row range"):
        csr_segment_sum(torch.from_numpy(data), t["receivers"], t["row_bounds"])


def test_reference_drops_masked_edges_anywhere():
    data, recv = _sorted_case(50, 300, 8, seed=4)
    mask = np.random.default_rng(5).random(300) > 0.3
    got = csr_segment_sum_reference(
        torch.from_numpy(data), torch.from_numpy(recv), 50, torch.from_numpy(mask)
    )
    want = jax_seg.masked_segment_sum(
        jnp.asarray(data), jnp.asarray(recv), 50, mask=jnp.asarray(mask)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sorted_layout", [False, True])
def test_masked_segment_sum_matches_jax(dtype, sorted_layout):
    r = np.random.default_rng(6)
    n, e, h = 60, 400, 24
    recv = r.integers(0, n, e).astype(np.int32)
    if sorted_layout:
        recv = np.sort(recv)
    data = r.normal(size=(e, h)).astype(np.float32)
    mask = r.random(e) > 0.2
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_seg.masked_segment_sum(
        jnp.asarray(data).astype(jdtype), jnp.asarray(recv), n, mask=jnp.asarray(mask)
    )
    row_bounds = torch.from_numpy(compute_row_bounds(recv, n)) if sorted_layout else None
    got = masked_segment_sum(
        torch.from_numpy(data).to(dtype), torch.from_numpy(recv), n,
        mask=torch.from_numpy(mask), row_bounds=row_bounds,
    )
    assert got.dtype == dtype
    # bf16: one rounding of an f32 sum on both sides (half an ulp of ~8 bits)
    tol = dict(rtol=RTOL, atol=ATOL) if dtype == torch.float32 else dict(rtol=1e-2, atol=2e-2)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol
    )


def test_take_rows_matches_jnp_take():
    r = np.random.default_rng(7)
    x = r.normal(size=(30, 5)).astype(np.float32)
    idx = r.integers(0, 30, 80).astype(np.int32)
    np.testing.assert_array_equal(
        take_rows(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
        np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx), axis=0)),
    )


def _fake_nvcc(tmp_path, monkeypatch, body):
    from graphphysics_torch.ops import _native

    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!/bin/sh\n{body}\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_native, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    return _native


def test_build_is_bounded_by_its_timeout(tmp_path, monkeypatch):
    native = _fake_nvcc(tmp_path, monkeypatch, "echo compiling; exec sleep 30")
    with pytest.raises(RuntimeError, match="did not finish within") as info:
        native.build(timeout=0.5)
    assert "compiling" in str(info.value)  # the compiler's output comes with the error
    assert list((tmp_path / "build").iterdir()) == []  # no library, log or partial file left


def test_build_reports_compiler_errors(tmp_path, monkeypatch):
    native = _fake_nvcc(tmp_path, monkeypatch, "echo 'error: no such thing'; exit 1")
    with pytest.raises(RuntimeError, match="nvcc failed for csr_softmax_spmm.cu") as info:
        native.build(["csr_softmax_spmm.cu"])
    assert "error: no such thing" in str(info.value)
    assert list((tmp_path / "build").iterdir()) == []

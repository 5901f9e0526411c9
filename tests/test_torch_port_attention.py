"""Port parity, attention ops: ``segment_softmax``, the plain version of the
fused softmax + SpMM (``csr_softmax_spmm_reference``, through
``csr_softmax_spmm`` on CPU tensors), its host helpers and both branches of
``sparse_graph_attention``, against the JAX package's Pallas kernel (in
interpret mode), its helpers and its COO and CSR attention. Inputs come from
numpy with a seed and go to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.ops import attention as jax_attention
from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_tpu.ops import segment as jax_seg
from graphphysics_torch.core.graph import pad_graph_csr_np, pad_graph_sorted_np
from graphphysics_torch.ops.attention import sparse_graph_attention
from graphphysics_torch.ops.csr_attention import (
    NEG,
    compute_block_bounds,
    compute_max_chunks_bounds,
    csr_softmax_spmm,
    csr_softmax_spmm_reference,
)
from graphphysics_torch.ops.csr_segment import compute_row_bounds
from graphphysics_torch.ops.segment import segment_softmax
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# f32 exponentials and sums in another order (online softmax in the TPU
# kernel, two passes here): the tolerance of tests/test_pallas_attention.py
RTOL, ATOL = 1e-5, 1e-5


def _case(n, e, h, dh, seed, hi=None, mask_frac=0.0, n_pad_equal=False):
    """Sender-sorted inputs of the kernel. ``hi`` crowds every edge into the
    first ``hi`` nodes (skew, empty rows); ``n_pad_equal`` appends padded
    edges on the real last node, masked, as ``pad_graph_csr_np`` does when
    ``n_pad == n``."""
    r = np.random.default_rng(seed)
    seg = np.sort(r.integers(0, n if hi is None else hi, e)).astype(np.int32)
    mask = r.random(e) >= mask_frac
    num_real = e
    if n_pad_equal:
        seg = np.concatenate([seg, np.full(e // 8, n - 1, np.int32)])
        mask = np.concatenate([mask, np.zeros(e // 8, bool)])
    scores = r.normal(size=(len(seg), h)).astype(np.float32)
    values = r.normal(size=(len(seg), h * dh)).astype(np.float32)
    return scores, values, seg, mask, num_real


def _jax_kernel(scores, values, seg, mask, n, num_real):
    """JAX's ``_softmax_spmm_impl`` fed as ``csr_sparse_attention`` feeds it:
    masked edges carry score -1e30 and segment N, block ranges stop at the
    real edges."""
    s = np.where(mask[:, None], scores, jax_pa._NEG).astype(np.float32)
    sg = np.where(mask, seg, n).astype(np.int32)
    bounds = jax_pa.compute_block_bounds(seg, n, num_real_edges=num_real)
    with pltpu.force_tpu_interpret_mode():
        out, ml = jax_pa._softmax_spmm_impl(
            jnp.asarray(s), jnp.asarray(values), jnp.asarray(sg), jnp.asarray(bounds), n,
            scores.shape[1], jax_pa.BLOCK_NODES, jax_pa.BLOCK_EDGES,
            jax_pa.compute_max_chunks_bounds(bounds),
        )
    return np.asarray(out), np.asarray(ml)


@pytest.mark.parametrize(
    "n,e,h,dh,hi,mask_frac,n_pad_equal",
    [
        (600, 3000, 4, 16, None, 0.0, False),  # shapes of tests/test_pallas_attention.py
        (1024, 4096, 8, 16, None, 0.0, False),
        (1024, 4096, 4, 16, 8, 0.0, False),  # skew: 8 long rows, the rest empty
        (500, 2400, 4, 8, None, 0.2, False),  # masked edges inside the ranges
        (256, 1500, 4, 32, None, 0.1, True),  # n_pad == n: padding on the real last node
    ],
)
def test_softmax_spmm_matches_pallas_kernel(n, e, h, dh, hi, mask_frac, n_pad_equal):
    scores, values, seg, mask, num_real = _case(n, e, h, dh, seed=n + e, hi=hi,
                                                mask_frac=mask_frac, n_pad_equal=n_pad_equal)
    want_out, want_ml = _jax_kernel(scores, values, seg, mask, n, num_real)
    bounds = compute_row_bounds(seg, n, num_real_edges=num_real)
    got_out, got_ml = csr_softmax_spmm(
        torch.from_numpy(np.where(mask[:, None], scores, NEG).astype(np.float32)),
        torch.from_numpy(values), torch.from_numpy(seg), torch.from_numpy(bounds),
        torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got_out.numpy(), want_out, rtol=RTOL, atol=ATOL)
    assert got_ml.shape == want_ml.shape == (2 * h, n)
    m, l = got_ml[:h].numpy(), got_ml[h:].numpy()
    live = want_ml[h:] > 0
    np.testing.assert_array_equal(l > 0, live)
    np.testing.assert_allclose(m[live], want_ml[:h][live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l, want_ml[h:], rtol=RTOL, atol=ATOL)
    # rows without an unmasked edge: output 0, m = -1e30, l = 0, as the TPU kernel
    assert np.all(m[~live] == np.float32(NEG)) and np.all(want_ml[:h][~live] == np.float32(NEG))
    empty = ~live.any(axis=0)
    assert np.all(got_out.numpy()[empty] == 0.0)
    if hi is not None:
        assert empty[hi:].all()


def test_reference_matches_explicit_formula():
    """out = sum exp(s - m) v / (l + 1e-16) per head, with the stats it
    returns, independently of segment_softmax."""
    scores, values, seg, mask, _ = _case(40, 300, 2, 32, seed=3, mask_frac=0.3)
    out, ml = csr_softmax_spmm_reference(
        torch.from_numpy(scores), torch.from_numpy(values), torch.from_numpy(seg), 40,
        torch.from_numpy(mask),
    )
    m, l = ml[:2].numpy().T, ml[2:].numpy().T  # [N, H]
    want = np.zeros((40, 64), np.float64)
    for e in np.nonzero(mask)[0]:
        p = np.exp(scores[e].astype(np.float64) - m[seg[e]])
        want[seg[e]] += np.repeat(p, 32) * values[e]
    want /= np.repeat(l, 32, axis=1) + 1e-16
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)


def test_cpu_path_refuses_a_receiver_sorted_layout():
    r = np.random.default_rng(0)
    n, e = 128, 600
    g = pad_graph_sorted_np(
        np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
        r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32), n, 640,
    )
    with pytest.raises(ValueError, match="sender's row range"):
        csr_softmax_spmm(
            torch.zeros(640, 4), torch.zeros(640, 32), torch.from_numpy(g.senders),
            torch.from_numpy(g.row_bounds), torch.from_numpy(g.edge_mask),
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_helpers_match_jax(seed):
    r = np.random.default_rng(seed)
    n = int(r.integers(100, 3000))
    e = int(r.integers(10, 9000))
    seg = np.sort(r.integers(0, n, e)).astype(np.int32)
    real = int(r.integers(0, e + 1))
    for num_real in (None, real):
        got = compute_block_bounds(seg, n, num_real_edges=num_real)
        want = jax_pa.compute_block_bounds(seg, n, num_real_edges=num_real)
        np.testing.assert_array_equal(got, want)
        assert compute_max_chunks_bounds(got) == jax_pa.compute_max_chunks_bounds(want)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(dtype, masked):
    r = np.random.default_rng(4)
    n, e = 50, 400
    seg = r.integers(0, n - 5, e).astype(np.int32)  # the last 5 segments stay empty
    scores = (3 * r.normal(size=(e, 4))).astype(dtype)
    mask = None
    if masked:
        mask = r.random(e) > 0.3
        mask[seg == 7] = False  # a segment with only masked edges
    want = jax_seg.segment_softmax(
        jnp.asarray(scores), jnp.asarray(seg), n, mask=None if mask is None else jnp.asarray(mask)
    )
    got = segment_softmax(
        torch.from_numpy(scores), torch.from_numpy(seg), n,
        mask=None if mask is None else torch.from_numpy(mask),
    )
    assert got.dtype == torch.from_numpy(scores).dtype
    tol = 1e-6 if dtype == np.float32 else 1e-3
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol)
    if masked:
        assert torch.all(got[torch.from_numpy(~mask)] == 0)


def _attention_case(n, e, h, dh, seed, n_pad, e_pad):
    r = np.random.default_rng(seed)
    g = pad_graph_csr_np(
        np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
        r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32),
        n_pad, e_pad,
    )
    qkv = [r.normal(size=(n_pad, h, dh)).astype(np.float32) for _ in range(3)]
    return g, qkv


@pytest.mark.parametrize("n,n_pad", [(500, 512), (384, 384)])  # the second: n_pad == n
def test_sparse_graph_attention_branches_match_jax(n, n_pad):
    h, dh, e, e_pad = 4, 8, 2400, 2816
    g, qkv = _attention_case(n, e, h, dh, seed=n, n_pad=n_pad, e_pad=e_pad)
    scale = h ** -0.5
    args = [jnp.asarray(a) for a in qkv] + [jnp.asarray(g.senders), jnp.asarray(g.receivers)]
    want_coo = jax_attention.sparse_graph_attention(
        *args, num_nodes=n_pad, edge_mask=jnp.asarray(g.edge_mask), scale=scale
    )
    bounds = jax_pa.compute_block_bounds(g.senders, n_pad, num_real_edges=e)
    with pltpu.force_tpu_interpret_mode():
        want_csr = jax_attention.sparse_graph_attention(
            *args, num_nodes=n_pad, edge_mask=jnp.asarray(g.edge_mask), scale=scale,
            csr_bounds=jnp.asarray(bounds),
            csr_max_chunks=jax_pa.compute_max_chunks_bounds(bounds),
        )
    t = [torch.from_numpy(a) for a in qkv]
    common = dict(num_nodes=n_pad, edge_mask=torch.from_numpy(g.edge_mask), scale=scale)
    got_coo = sparse_graph_attention(
        *t, torch.from_numpy(g.senders), torch.from_numpy(g.receivers), **common
    )
    got_csr = sparse_graph_attention(
        *t, torch.from_numpy(g.senders), torch.from_numpy(g.receivers),
        sender_bounds=torch.from_numpy(g.sender_bounds), **common,
    )
    for got, want in ((got_coo, want_coo), (got_csr, want_csr), (got_csr, want_coo)):
        assert got.shape == (n_pad, h, dh)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

"""Port parity, the word geometries of K2's entries and of K1's f32 entry,
on the CPU:

- ``csr_attention.stream_geometry`` with ``pair=False``, the rule by which
  ``csrc/csr_softmax_spmm.cu`` chooses the lane geometry of
  ``csr_softmax_spmm_bf16_stream`` (K5's rule on K2's widths), with its
  refusals; ``pair_stream_geometry`` is the same rule for K5.
- ``csr_attention.softmax_spmm_geometry``, the rule by which the same
  source chooses the geometry of the f32 entry ``csr_softmax_spmm_f32``
  (16-byte words of 4 columns where a head is 4k wide and D <= 128, else
  D/32 columns a lane), with the widths it refuses as the wrapper does.
- The orders in which K2's word geometries add a row's edges, emulated in
  PyTorch and held against JAX's ``csr_softmax_spmm`` (K2 in TPU
  interpret mode) and the port's plain version, on a row of only masked
  edges, a masked whole window, a 4,096-edge hub row and empty rows: the
  bf16 stream's (windows of 8 edges, the window's maximum first, one
  rescale of ``l`` and the sums a window, one exponential a live edge)
  and the f32 entry's (the online step an edge, in edge order).

Inputs come from numpy with a seed and go to both sides."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.ops import pallas_attention as jax_pa
from graphphysics_torch.ops import csr_attention as ca
from graphphysics_torch.ops.csr_segment import EDGE_GROUP, F32_WORD_COLUMNS, compute_row_bounds
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# both sides compute in f32 from the same bf16-rounded scores and values;
# they differ by f32 round-off of the softmax and the sums
WINDOW_RTOL, WINDOW_ATOL = 1e-5, 1e-5
HUB_EDGES = 4096


@pytest.mark.parametrize("width,heads,aligned,want", [
    (128, 4, 16, ("words16", 8, 16, 2, 8)),  # the panels width: 16 lanes, two rows a warp
    (64, 4, 16, ("words16", 8, 8, 4, 8)),  # the aneurysm width: four rows a warp
    (32, 4, 16, ("words16", 8, 4, 8, 8)),  # eight rows a warp
    (256, 8, 16, ("words16", 8, 32, 1, 8)),  # 32 lanes
    (160, 1, 16, ("words16", 8, 32, 1, 8)),  # 20 words: 32 lanes, twelve idle
    (32, 8, 16, ("words8", 4, 8, 4, 8)),  # heads of 4: 8-byte words
    (128, 4, 8, ("words8", 4, 32, 1, 8)),  # values 8-byte aligned
    (64, 4, 4, ("general", 2, 32, 1, 1)),  # values 4-byte aligned: 4-byte loads of 2 columns
    (512, 4, 16, ("general", 16, 32, 1, 1)),  # past 32 words
    (64, 32, 16, ("general", 2, 32, 1, 1)),  # heads of 2
])
def test_softmax_spmm_stream_geometry(width, heads, aligned, want):
    assert tuple(ca.stream_geometry(width, heads, aligned, pair=False)) == want


@pytest.mark.parametrize("width,heads,aligned", [
    (48, 4, 16),  # not a multiple of 32 (K5 takes it in 8-byte words)
    (96, 3, 16),  # heads of 32 not whole 3-column lanes
    (544, 4, 16),  # past MAX_WIDTH
    (128, 0, 16),
    (130, 4, 16),
    (128, 4, 4),  # the general kernel's 8-byte loads on a 4-byte view
    (512, 4, 8),  # its 16-byte loads on an 8-byte view
])
def test_softmax_spmm_stream_geometry_refuses_what_the_entry_refuses(width, heads, aligned):
    assert ca.stream_geometry(width, heads, aligned, pair=False) is None


@pytest.mark.parametrize("width,heads,aligned", [(128, 4, 16), (48, 4, 16), (128, 4, 4), (40, 8, 2)])
def test_pair_stream_geometry_is_the_shared_rule(width, heads, aligned):
    assert ca.pair_stream_geometry(width, heads, aligned) == ca.stream_geometry(width, heads, aligned)


@pytest.mark.parametrize("width,heads,want", [
    (128, 4, ("words16", 4, 32, 1, 8)),  # the mesh part, the frame, the panels batch: a row a warp
    (128, 8, ("words16", 4, 32, 1, 8)),  # heads of 16
    (64, 4, ("words16", 4, 16, 2, 8)),  # the aneurysm width: two rows a warp
    (32, 8, ("words16", 4, 8, 4, 8)),  # heads of 4: four rows a warp
    (96, 1, ("words16", 4, 32, 1, 8)),  # 24 words: 32 lanes, eight idle
    (32, 16, ("general", 1, 32, 1, 1)),  # heads of 2: one column a lane
    (256, 4, ("general", 8, 32, 1, 1)),  # past 128 wide
    (512, 8, ("general", 16, 32, 1, 1)),
])
def test_softmax_spmm_f32_geometry(width, heads, want):
    assert tuple(ca.softmax_spmm_geometry(width, heads)) == want


@pytest.mark.parametrize("width,heads", [
    (40, 8),  # not a multiple of 32
    (48, 4),
    (96, 3),  # heads of 32 not whole 3-column lanes
    (544, 4),  # past MAX_WIDTH
    (128, 0),
])
def test_softmax_spmm_f32_geometry_refuses_what_the_wrapper_refuses(width, heads):
    assert ca.softmax_spmm_geometry(width, heads) is None
    e = 8
    args = (torch.zeros((e, heads)), torch.zeros((e, width)),
            torch.zeros(e, dtype=torch.int32), torch.zeros((2, 4), dtype=torch.int32), None)
    with pytest.raises(ValueError, match="csr_softmax_spmm"):
        ca._check_cuda_args("csr_softmax_spmm", *args)


def test_softmax_spmm_f32_rule_follows_the_kernels_constants():
    source = (Path(ca.__file__).resolve().parents[1] / "csrc" / ca.SOURCE).read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", source).group(1))

    assert constant("kF32WordCols") == F32_WORD_COLUMNS
    assert constant("kEdgeGroup") == EDGE_GROUP


def windowed(s, v, bounds, mask, heads, window=EDGE_GROUP):
    """K2's word geometries' order, in f32 PyTorch: each row's range walked
    in windows of ``window`` edges; a window's maximum over its live edges
    first, ``l`` and the sums rescaled once by ``exp(m - m_new)``, then each
    live edge's ``p = exp(s - m_new)`` added to ``l`` and ``p * v`` to the
    sums in edge order. All rows advance window by window together.
    Returns ``(out [N, D], ml [2H, N])``."""
    n, d = bounds.shape[1], v.shape[1]
    dh = d // heads
    start, end = bounds[0].long(), bounds[1].long()
    m = torch.full((n, heads), ca.NEG)
    l = torch.zeros((n, heads))
    acc = torch.zeros((n, heads, dh))
    longest = int((end - start).clamp(min=0).max())
    for w0 in range(0, longest, window):
        edges = start[:, None] + w0 + torch.arange(window)  # [N, window]
        inside = edges < end[:, None]
        e = torch.where(inside, edges, torch.zeros((), dtype=edges.dtype))
        live = inside & mask[e]
        x = s[e]  # [N, window, H]
        m_new = torch.maximum(m, torch.where(live[..., None], x, torch.full((), ca.NEG)).amax(dim=1))
        alpha = torch.exp(m - m_new)
        l = l * alpha
        acc = acc * alpha[..., None]
        for u in range(window):
            p = torch.where(live[:, u, None], torch.exp(x[:, u] - m_new), torch.zeros(()))
            l = l + p
            acc = acc + p[..., None] * v[e[:, u]].reshape(n, heads, dh)
        m = m_new
    out = (acc / (l[..., None] + ca.EPS)).reshape(n, d)
    return out, torch.cat([m.t(), l.t()])


def windowed_stream(scores, values, bounds, mask, heads):
    """K2's bf16 stream entry in its word geometries' order: ``windowed`` on
    the scores and values rounded to bf16."""
    return windowed(ca.stream_round(scores), ca.stream_round(values), bounds, mask, heads)


def online_f32(scores, values, bounds, mask, heads):
    """K2's f32 entry in its kernels' order, in f32 PyTorch: each row's
    live edges in edge order, each an online step ``m' = max(m, s)``,
    ``l = l * exp(m - m') + exp(s - m')``, ``acc = acc * exp(m - m') +
    exp(s - m') * v`` (the 16-byte words load 8 edges at once and step
    through them alike). All rows advance edge by edge together. Returns
    ``(out [N, D], ml [2H, N])``."""
    n, d = bounds.shape[1], values.shape[1]
    dh = d // heads
    start, end = bounds[0].long(), bounds[1].long()
    m = torch.full((n, heads), ca.NEG)
    l = torch.zeros((n, heads))
    acc = torch.zeros((n, heads, dh))
    longest = int((end - start).clamp(min=0).max())
    for t in range(longest):
        edge = start + t
        inside = edge < end
        e = torch.where(inside, edge, torch.zeros((), dtype=edge.dtype))
        live = (inside & mask[e])[:, None]  # [N, 1]
        s = scores[e]
        m_new = torch.where(live, torch.maximum(m, s), m)
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new), torch.zeros(()))
        l = torch.where(live, l * alpha + p, l)
        acc = torch.where(live[..., None], acc * alpha[..., None] + p[..., None] * values[e].reshape(n, heads, dh),
                          acc)
        m = m_new
    out = (acc / (l[..., None] + ca.EPS)).reshape(n, d)
    return out, torch.cat([m.t(), l.t()])


def _window_case():
    """A sender-sorted layout of 300 rows, 4 heads of 16: row 0 a hub of
    4,096 edges; row 1 twenty edges, all masked; row 2 twenty-four edges
    whose second window (edges 8-15 of the row) is masked; rows 3-9 empty;
    the rest 0-12 edges each, some empty, a tenth of their edges masked."""
    r = np.random.default_rng(19)
    n, h, dh = 300, 4, 16
    counts = np.concatenate([[HUB_EDGES, 20, 24], np.zeros(7, int), r.integers(0, 13, n - 10)])
    seg = np.repeat(np.arange(n), counts).astype(np.int32)
    e = len(seg)
    mask = r.random(e) >= 0.1
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    mask[first[0]:first[0] + HUB_EDGES] = r.random(HUB_EDGES) >= 0.1
    mask[first[1]:first[1] + 20] = False
    mask[first[2]:first[2] + 24] = True
    mask[first[2] + 8:first[2] + 16] = False
    scores = (3 * r.normal(size=(e, h))).astype(np.float32)
    values = r.normal(size=(e, h * dh)).astype(np.float32)
    return n, h, seg, mask, scores, values, counts


def _hold_row_order(emulate, stream_dtype):
    """``emulate`` (``windowed_stream`` or ``online_f32``) on
    ``_window_case`` against JAX's ``csr_softmax_spmm`` and
    ``_softmax_spmm_impl``'s ``ml`` in TPU interpret mode, and against the
    port's plain version, for ``stream_dtype``; then the rows the case is
    built for."""
    n, h, seg, mask, scores, values, counts = _window_case()
    bounds = compute_row_bounds(seg, n)
    s = np.where(mask[:, None], scores, jax_pa._NEG).astype(np.float32)
    sg = np.where(mask, seg, n).astype(np.int32)
    block_bounds = jax_pa.compute_block_bounds(seg, n, num_real_edges=len(seg))
    args = (jnp.asarray(s), jnp.asarray(values), jnp.asarray(sg), jnp.asarray(block_bounds), n)
    chunks = jax_pa.compute_max_chunks_bounds(block_bounds)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pa.csr_softmax_spmm(*args, max_chunks=chunks, stream_dtype=stream_dtype)
        _, want_ml = jax_pa._softmax_spmm_impl(*args, h, jax_pa.BLOCK_NODES, jax_pa.BLOCK_EDGES, chunks,
                                               stream_dtype=stream_dtype)
    ts, tv, tb, tm = (torch.from_numpy(a) for a in (scores, values, bounds, mask))
    out, ml = emulate(ts, tv, tb, tm, h)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=WINDOW_RTOL, atol=WINDOW_ATOL)
    np.testing.assert_allclose(ml.numpy(), np.asarray(want_ml), rtol=WINDOW_RTOL, atol=WINDOW_ATOL)
    plain, plain_ml = ca.csr_softmax_spmm(ts, tv, torch.from_numpy(seg), tb, tm, stream_dtype=stream_dtype)
    torch.testing.assert_close(out, plain, rtol=WINDOW_RTOL, atol=WINDOW_ATOL)
    torch.testing.assert_close(ml, plain_ml, rtol=WINDOW_RTOL, atol=WINDOW_ATOL)
    # the rows the case is built for: no live edge keeps m = -1e30, l = 0, out = 0
    empty = np.flatnonzero((counts == 0) | (np.arange(n) == 1))
    assert len(empty) >= 8 and 1 in empty
    assert bool((out[empty] == 0).all()) and bool((ml[h:, empty] == 0).all())
    assert bool((ml[:h, empty] == ca.NEG).all())
    # the masked window and the hub row read only their live edges
    assert float(ml[h:, 0].min()) > 1.0 and float(ml[h:, 2].min()) > 0.0


def test_windowed_stream_order_matches_jax():
    _hold_row_order(windowed_stream, "bf16")


def test_online_f32_order_matches_jax():
    _hold_row_order(online_f32, "f32")

"""Port parity, the lane geometries of K2's entries and of K3, and of K1's
f32 entry, on the CPU:

- ``csr_attention.stream_geometry``, the rule by which
  ``csrc/csr_softmax_spmm.cu`` chooses the lane geometry of
  ``csr_softmax_spmm_bf16_stream``, with its refusals; it is K5's rule
  at every width (both sources choose their bf16 words by one loop).
- ``csr_attention.softmax_spmm_geometry``, the rule by which the same
  source chooses the geometry of the f32 entry ``csr_softmax_spmm_f32``
  (16-byte words of 4 columns where a head is 4k wide, D <= 128 and the
  values 16-byte aligned, else the general kinds), and
  ``softmax_spmm_columns``, which general kernel K2 and K3 run (the
  adjacent V columns, or the general geometry's strided columns), with
  the widths they refuse as the wrapper does.
- The orders in which K2's geometries add a row's edges, emulated in
  PyTorch and held against JAX's ``csr_softmax_spmm`` (K2 in TPU
  interpret mode) and the port's plain version, on a row of only masked
  edges, a masked whole window, a 4,096-edge hub row and empty rows: the
  bf16 stream's words (windows of 8 edges, the window's maximum first, one
  rescale of ``l`` and the sums a window, one exponential a live edge),
  the f32 entry's (the online step an edge, in edge order) and the
  general geometry's (lane j the columns j, j + 32, ..., each with its
  head's online step an edge) at widths only it takes, f32 and bf16
  stream; and K3's general geometry (per-head sums over strided columns,
  zeros on masked edges) against JAX's ``_bwd``.

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
    # refused before the general geometry: not a multiple of 32, heads not
    # whole 3-column lanes, views the V columns' loads do not take
    (48, 4, 16, ("words8", 4, 16, 2, 8)),  # heads of 12: 8-byte words, 12 lanes of 16
    (96, 3, 16, ("words16", 8, 16, 2, 8)),  # heads of 32: 12 lanes of 16
    (128, 4, 4, ("general", 4, 32, 1, 1)),  # strided: the V columns' 8-byte loads on a 4-byte view
    (512, 4, 8, ("general", 16, 32, 1, 1)),  # strided: their 16-byte loads on an 8-byte view
    (40, 8, 16, ("general", 2, 32, 1, 1)),  # heads of 5
])
def test_softmax_spmm_stream_geometry(width, heads, aligned, want):
    assert tuple(ca.stream_geometry(width, heads, aligned)) == want


@pytest.mark.parametrize("width,heads,aligned", [
    (544, 4, 16),  # past MAX_WIDTH
    (128, 0, 16),
    (130, 4, 16),  # H not dividing D
    (64, 3, 16),
])
def test_softmax_spmm_stream_geometry_refuses_what_the_entry_refuses(width, heads, aligned):
    assert ca.stream_geometry(width, heads, aligned) is None


@pytest.mark.parametrize("width,heads,aligned", [
    (128, 4, 16), (48, 4, 16), (128, 4, 4), (40, 8, 2),
    (96, 3, 16), (512, 4, 8), (16, 4, 2), (24, 3, 4), (544, 4, 16), (64, 3, 16),
])
def test_pair_stream_geometry_is_the_shared_rule(width, heads, aligned):
    """K2's stream rule is K5's at every width, those K2 refused before
    its general geometry included, and so are their refusals: both
    sources take a bf16 word of w in (8, 4) columns where a head is a
    multiple of w, D is at most 32 w and the values are 2 w-byte aligned,
    else the general geometry, and ``stream_geometry``, the one rule's
    mirror, gives that."""
    csrc = Path(ca.__file__).resolve().parents[1] / "csrc"
    for source, aligned_test in ((ca.SOURCE, "% (sizeof(T) * w) != 0"), (ca.PAIR_SOURCE, "% (2 * w) == 0")):
        text = (csrc / source).read_text()
        assert "for (int w : {8, 4}) {" in text and aligned_test in text
        assert "if (head_dim % w != 0 || width > kLanes * w) continue;" in text
    got = ca.stream_geometry(width, heads, aligned)
    if not (0 < width <= ca.MAX_WIDTH and heads > 0 and width % heads == 0):
        assert got is None
        return
    words = [w for w in (8, 4) if (width // heads) % w == 0 and width <= 32 * w and aligned % (2 * w) == 0]
    assert got.kind == ({8: "words16", 4: "words8"}[words[0]] if words else "general")


@pytest.mark.parametrize("width,heads,want", [
    (128, 4, ("words16", 4, 32, 1, 8)),  # the mesh part, the frame, the panels batch: a row a warp
    (128, 8, ("words16", 4, 32, 1, 8)),  # heads of 16
    (64, 4, ("words16", 4, 16, 2, 8)),  # the aneurysm width: two rows a warp
    (32, 8, ("words16", 4, 8, 4, 8)),  # heads of 4: four rows a warp
    (96, 1, ("words16", 4, 32, 1, 8)),  # 24 words: 32 lanes, eight idle
    (32, 16, ("general", 1, 32, 1, 1)),  # heads of 2: one column a lane
    (256, 4, ("general", 8, 32, 1, 1)),  # past 128 wide
    (512, 8, ("general", 16, 32, 1, 1)),
    # refused before the general geometry (not a multiple of 32, heads not
    # whole 3-column lanes): heads 4k wide take 16-byte words
    (40, 8, ("words", 4, 16, 2, 8)),  # heads of 5: 10 words spanning two heads, 16 lanes
    (48, 4, ("words16", 4, 16, 2, 8)),  # heads of 12: 12 lanes of 16, two rows a warp
    (96, 3, ("words16", 4, 32, 1, 8)),  # heads of 32: 24 lanes of 32
])
def test_softmax_spmm_f32_geometry(width, heads, want):
    assert tuple(ca.softmax_spmm_geometry(width, heads)) == want


@pytest.mark.parametrize("width,heads,aligned,want", [
    (128, 4, 8, ("general", 4, 32, 1, 1)),  # no 16-byte words on an 8-byte view
    (48, 4, 4, ("general", 2, 32, 1, 1)),
    (64, 4, 16, ("words16", 4, 16, 2, 8)),
])
def test_softmax_spmm_f32_geometry_by_alignment(width, heads, aligned, want):
    """The f32 entry's words need the values 16-byte aligned (out is the
    wrapper's own); any other view takes a general kind."""
    assert tuple(ca.softmax_spmm_geometry(width, heads, aligned)) == want


@pytest.mark.parametrize("width,heads,aligned,itemsize,want", [
    (256, 4, 16, 4, "adjacent"),  # the V columns: 8 a lane, 16-byte loads
    (32, 16, 4, 4, "adjacent"),  # one column a lane takes any f32 view
    (96, 4, 4, 4, "adjacent"),  # 3 columns a lane: 4-byte loads
    (256, 4, 8, 4, "strided"),  # 16-byte loads on an 8-byte view
    (48, 4, 16, 4, "words"),  # not a multiple of 32: 16-byte words, 12 lanes of 16
    (96, 3, 16, 4, "words"),  # heads of 32 not whole 3-column lanes: 24 words of 32 lanes
    (40, 8, 16, 4, "words"),  # heads of 5: words spanning two heads
    (16, 4, 16, 4, "words"),  # half a warp of columns: 4 words
    (48, 4, 4, 4, "strided"),  # a 4-byte view: 48 single columns, past 32 lanes
    (32, 8, 4, 4, "adjacent"),  # the V columns before the words
    (512, 4, 16, 2, "adjacent"),  # bf16 stream: 16-byte loads of 8 columns
    (512, 4, 8, 2, "strided"),
    (128, 4, 4, 2, "strided"),  # 8-byte loads of 4 bf16 columns on a 4-byte view
    (64, 4, 4, 2, "adjacent"),  # 4-byte loads of 2 bf16 columns
])
def test_softmax_spmm_columns(width, heads, aligned, itemsize, want):
    """Which kernel a "general" geometry of K2 or K3 is: the V columns
    where the width, heads and alignment allow, else in f32 the words where
    their lanes hold the row, else the strided general geometry."""
    assert ca.softmax_spmm_columns(width, heads, aligned, itemsize) == want


@pytest.mark.parametrize("width,heads", [
    (544, 4),  # past MAX_WIDTH
    (128, 0),
    (130, 4),  # H not dividing D
    (64, 3),
])
def test_softmax_spmm_f32_geometry_refuses_what_the_wrapper_refuses(width, heads):
    assert ca.softmax_spmm_geometry(width, heads) is None
    e = 8
    args = (torch.zeros((e, heads)), torch.zeros((e, width)),
            torch.zeros(e, dtype=torch.int32), torch.zeros((2, 4), dtype=torch.int32), None)
    with pytest.raises(ValueError, match="csr_softmax_spmm"):
        ca._check_cuda_args("csr_softmax_spmm", *args)


@pytest.mark.parametrize("width,heads", [(48, 4), (96, 3), (40, 8), (16, 4), (24, 3), (512, 8)])
def test_wrapper_takes_every_width_jax_takes(width, heads):
    """The CUDA wrapper's checks take every D <= 512 with D % H == 0, as
    JAX's K2 (its only shape assertion, pallas_attention.py:269), and a
    values view of any alignment."""
    e = 8
    values = torch.zeros(e * width + 1)[1:].view(e, width)  # 4-byte aligned
    ca._check_cuda_args("csr_softmax_spmm", torch.zeros((e, heads)), values,
                        torch.zeros(e, dtype=torch.int32), torch.zeros((2, 4), dtype=torch.int32), None)


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


def general_order(scores, values, bounds, mask, heads, stream=False):
    """K2's general geometry (``csrc/softmax_general.cuh``) in its order, in
    f32 PyTorch: lane j of a row's warp owns the columns j, j + 32, ...
    below D; each column walks the row's live edges in edge order with its
    head's online step (``m' = max(m, s)``, ``l = l exp(m - m') + exp(s -
    m')``, ``acc = acc exp(m - m') + exp(s - m') v``), reading its head's
    score and its own value; ``out = acc / (l + 1e-16)``, and the lane of a
    head's first column gives ``ml``. ``stream``: on scores and values
    rounded to bf16 (the stream entry reads them so). All rows advance edge
    by edge together. Returns ``(out [N, D], ml [2H, N])``."""
    if stream:
        scores, values = ca.stream_round(scores), ca.stream_round(values)
    n, d = bounds.shape[1], values.shape[1]
    dh = d // heads
    slots = -(-d // 32)
    cols = torch.arange(32)[:, None] + 32 * torch.arange(slots)[None, :]  # [lane, slot] -> column
    inside_width = cols < d
    col = torch.where(inside_width, cols, torch.zeros((), dtype=cols.dtype))
    head = col // dh
    m = torch.full((n, 32, slots), ca.NEG)
    l = torch.zeros((n, 32, slots))
    acc = torch.zeros((n, 32, slots))
    start, end = bounds[0].long(), bounds[1].long()
    longest = int((end - start).clamp(min=0).max())
    for t in range(longest):
        edge = start + t
        inside = edge < end
        e = torch.where(inside, edge, torch.zeros((), dtype=edge.dtype))
        live = (inside & mask[e])[:, None, None]  # [N, 1, 1]
        x = scores[e][:, head]  # [N, 32, slots]: each column its head's score
        v = values[e][:, col]
        m_new = torch.where(live, torch.maximum(m, x), m)
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(x - m_new), torch.zeros(()))
        l = torch.where(live, l * alpha + p, l)
        acc = torch.where(live, acc * alpha + p * v, acc)
        m = m_new
    out = torch.zeros((n, d))
    out[:, col[inside_width]] = (acc / (l + ca.EPS))[:, inside_width]
    first = inside_width & (col % dh == 0)
    ml = torch.zeros((2 * heads, n))
    ml[head[first]] = m[:, first].t()
    ml[heads + head[first]] = l[:, first].t()
    return out, ml


def general_order_stream(scores, values, bounds, mask, heads):
    """``general_order`` of the bf16 stream entry."""
    return general_order(scores, values, bounds, mask, heads, stream=True)


def column_head_sums(p, d, heads):
    """``column_head_sums`` of ``csrc/softmax_general.cuh`` in its order:
    ``p [..., 32, slots]``, lane j's slot i holding column j + 32 i (0 past
    D), to each column's sum over its head, ``[..., H]``. A head of whole
    32-column slots (kWarp): a butterfly over the 32 lanes of each slot
    (offsets 16, 8, 4, 2, 1; each lane adds its partner's value), then the
    head's slots added in slot order from 0. A head that divides 32
    (kGroup): the butterfly within its aligned lane group (offsets D/H/2
    down to 1). Else (kShared): from 0, the head's columns in column
    order."""
    dh = d // heads
    lanes = torch.arange(32)

    def butterfly(t, off):
        while off:
            t = t + t[..., lanes ^ off, :]
            off //= 2
        return t

    def in_column_order(t):
        return t.transpose(-1, -2).reshape(*t.shape[:-2], -1)[..., :d]

    sums = torch.zeros(p.shape[:-2] + (heads,))
    if dh % 32 == 0:  # kWarp: every lane holds its slot's sum
        per_slot = butterfly(p, 16)[..., 0, :]
        for k in range(dh // 32):  # slot k of each head
            sums = sums + per_slot[..., k::dh // 32]
        return sums
    if 32 % dh == 0:  # kGroup: every lane holds its group's, its head's, sum
        return in_column_order(butterfly(p, dh // 2))[..., ::dh]
    flat = in_column_order(p)  # kShared
    for j in range(dh):
        sums = sums + flat[..., j::dh]
    return sums


def _lanes(x, d):
    """``x [..., D]`` in the general geometry's registers: ``[..., 32,
    slots]``, lane j's slot i column j + 32 i, 0 past D."""
    slots = -(-d // 32)
    padded = torch.zeros(x.shape[:-1] + (32 * slots,))
    padded[..., :d] = x
    return padded.reshape(*x.shape[:-1], slots, 32).transpose(-1, -2)


def general_backward(scores, values, bounds, mask, ml, out, g, heads):
    """K3's general geometry (``csrc/softmax_general.cuh``) in f32 PyTorch,
    its per-head sums in ``column_head_sums``' order: per row delta, the
    head sums of ``out * g``; then per edge of the row's range ``attn =
    exp(s - m) / (l + 1e-16)``, ``dvalues = attn g``, ``dscores = attn
    (head sum of values g - delta)``; exactly 0 on masked edges and on the
    edges no range covers. Returns ``(dscores [E, H], dvalues [E, D])``."""
    e, d = values.shape
    dh = d // heads
    delta = column_head_sums(_lanes(out * g, d), d, heads)  # [N, H]
    row = torch.full((e,), -1, dtype=torch.long)
    for r, (lo, hi) in enumerate(bounds.t().tolist()):
        row[lo:hi] = r
    live = (row >= 0) & mask
    r = row.clamp(min=0)
    m, l = ml[:heads].t()[r], ml[heads:].t()[r]  # [E, H]
    attn = torch.where(live[:, None], torch.exp(scores - m) / (l + ca.EPS), torch.zeros(()))
    g_e = g[r]
    dvalues = torch.where(live[:, None], attn.repeat_interleave(dh, dim=1) * g_e, torch.zeros(()))
    dot = column_head_sums(_lanes(values * g_e, d), d, heads)
    dscores = torch.where(live[:, None], attn * (dot - delta[r]), torch.zeros(()))
    return dscores, dvalues


def _window_case(h=4, dh=16):
    """A sender-sorted layout of 300 rows, ``h`` heads of ``dh``: row 0 a
    hub of 4,096 edges; row 1 twenty edges, all masked; row 2 twenty-four
    edges whose second window (edges 8-15 of the row) is masked; rows 3-9
    empty; the rest 0-12 edges each, some empty, a tenth of their edges
    masked."""
    r = np.random.default_rng(19)
    n = 300
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


def _jax_forward(seg, mask, scores, values, n, h, stream_dtype):
    """JAX's ``csr_softmax_spmm`` and ``_softmax_spmm_impl``'s ``ml`` in TPU
    interpret mode, on the layout with masked edges given score -1e30 and
    segment N, as ``csr_sparse_attention`` hands them over. Returns
    ``(out, ml, (scores, values, segments) as JAX arrays, chunks)``."""
    s = np.where(mask[:, None], scores, jax_pa._NEG).astype(np.float32)
    sg = np.where(mask, seg, n).astype(np.int32)
    block_bounds = jax_pa.compute_block_bounds(seg, n, num_real_edges=len(seg))
    args = (jnp.asarray(s), jnp.asarray(values), jnp.asarray(sg), jnp.asarray(block_bounds), n)
    chunks = jax_pa.compute_max_chunks_bounds(block_bounds)
    with pltpu.force_tpu_interpret_mode():
        want = jax_pa.csr_softmax_spmm(*args, max_chunks=chunks, stream_dtype=stream_dtype)
        _, want_ml = jax_pa._softmax_spmm_impl(*args, h, jax_pa.BLOCK_NODES, jax_pa.BLOCK_EDGES, chunks,
                                               stream_dtype=stream_dtype)
    return want, want_ml, args[:3], chunks


def _hold_row_order(emulate, stream_dtype, heads=4, head_dim=16):
    """``emulate`` (``windowed_stream``, ``online_f32``, ``general_order``
    or ``general_order_stream``) on ``_window_case`` at ``heads`` heads of
    ``head_dim`` against JAX's ``csr_softmax_spmm`` and
    ``_softmax_spmm_impl``'s ``ml`` in TPU interpret mode, and against the
    port's plain version, for ``stream_dtype``; then the rows the case is
    built for."""
    n, h, seg, mask, scores, values, counts = _window_case(heads, head_dim)
    bounds = compute_row_bounds(seg, n)
    want, want_ml, _, _ = _jax_forward(seg, mask, scores, values, n, h, stream_dtype)
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


# (D, H) only the general geometry took when it came: heads of 12, 32 and 5
GENERAL_WIDTHS = [(48, 4), (96, 3), (40, 8)]


@pytest.mark.parametrize("stream_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width,heads", GENERAL_WIDTHS)
def test_general_order_matches_jax(width, heads, stream_dtype):
    emulate = general_order_stream if stream_dtype == "bf16" else general_order
    _hold_row_order(emulate, stream_dtype, heads, width // heads)


@pytest.mark.parametrize("width,heads", GENERAL_WIDTHS + [(16, 4), (64, 1)])
def test_general_backward_matches_jax(width, heads):
    """K3's general geometry, emulated with its head sums in their order
    (kShared at 48 x 4 and 40 x 8, kWarp at 96 x 3 and 64 x 1, two slots a
    head, kGroup at 16 x 4), against JAX's ``_bwd`` on JAX's own
    forward residuals (out and ml of the TPU kernel in interpret mode) and
    against the port's plain backward, at 1e-5; masked edges exactly 0."""
    n, h, seg, mask, scores, values, _ = _window_case(heads, width // heads)
    bounds = compute_row_bounds(seg, n)
    want, want_ml, (s, v, sg), chunks = _jax_forward(seg, mask, scores, values, n, h, "f32")
    g = np.random.default_rng(23).normal(size=(n, width)).astype(np.float32)
    ds_jax, dv_jax, _, _ = jax_pa._bwd(n, jax_pa.BLOCK_NODES, jax_pa.BLOCK_EDGES, chunks, "f32",
                                       (s, v, sg, want_ml, want), jnp.asarray(g))
    ts, tv, tb, tm = (torch.from_numpy(a) for a in (scores, values, bounds, mask))
    ml, out, tg = (torch.from_numpy(np.array(a)) for a in (want_ml, want, g))
    ds, dv = general_backward(ts, tv, tb, tm, ml, out, tg, h)
    for got, ref in ((ds, ds_jax), (dv, dv_jax)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        assert bool((got[~tm] == 0).all())
    plain = ca.csr_softmax_spmm_backward(ts, tv, torch.from_numpy(seg), tb, ml, out, tg, tm)
    for got, ref in zip((ds, dv), plain):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)

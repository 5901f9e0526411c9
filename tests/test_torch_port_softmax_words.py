"""Port parity, the word geometry of K2's f32 entry and of K3 on the CPU
(``csrc/csr_softmax_spmm.cu`` ``forward_words``, ``csrc/csr_softmax_spmm_bwd.cu``
``backward_words``, their rule and head sums in ``csrc/word_heads.cuh``):

- ``csr_attention.softmax_spmm_words``, ``softmax_spmm_geometry``,
  ``softmax_spmm_columns`` and ``softmax_spmm_kind``: W, L and the head
  sums' mode by width, heads and alignment, the V columns before the
  words, and every case the words do not take (more than 32 words, more
  than 16 heads, D % 4 != 0, views 8 or 4 bytes aligned, whose 8- and
  4-byte words ran no faster than the general geometry) kept on the
  general geometry; the rule against the kernels' constants and
  instantiations, read from the sources.
- The kernels' orders emulated in numpy f32: the forward's online step a
  head its word touches, each column taking its head's step, in edge
  order (bit-equal to the general geometry's column-by-column order); the
  backward's head sums of ``out * g`` and ``values * g`` in the
  reduce-scatter's order, one weight a head read back by the columns,
  zeros on masked edges and on the edges no range covers. Both held
  against the JAX package's K2 (``_softmax_spmm_impl`` in TPU interpret
  mode) and ``_bwd``, and against the port's plain versions, at 1e-5, on
  a layout with an odd row count, empty rows, a row of only masked edges
  and gaps between the ranges.

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
from graphphysics_torch.ops.csr_segment import EDGE_GROUP, WARP
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

# both sides in f32, the sums in other orders
ORDER_RTOL, ORDER_ATOL = 1e-5, 1e-5
CSRC = Path(ca.__file__).resolve().parents[1] / "csrc"

# (D, H, aligned) -> (W, L, P, ALIGNED, hi, K2's kind, K3's kind); P, ALIGNED
# and hi are K3's head sums
RULE_CASES = [
    (40, 8, 16, (4, 16, 8, False, 16, "words", "words")),  # heads of 5: 10 words, words span 2 heads
    (48, 4, 16, (4, 16, 4, False, 16, "words16", "words")),  # heads of 12: a select; K2's words of one head
    (96, 3, 16, (4, 32, 1, True, 8, "words16", "words")),  # heads of 32: a head's 8 lanes, ALIGNED
    (36, 4, 16, (4, 16, 4, False, 16, "words", "words")),  # heads of 9: 9 words, 7 idle lanes
    (20, 4, 16, (4, 8, 4, False, 8, "words", "words")),  # D % 8 == 4: 5 words
    (16, 16, 16, (4, 16, 16, False, 16, "words", "words")),  # heads of 1: a word spans 4 heads
    (12, 6, 16, (4, 8, 8, False, 8, "words", "words")),  # heads of 2: 3 words, 8 lanes for the heads
    (24, 1, 16, (4, 8, 1, True, 8, "words16", "words")),  # one head
    (80, 5, 16, (4, 32, 1, True, 4, "words16", "words")),  # heads of 16: 4 lanes a head
]
# (D, H, aligned): the V columns take them (K2 and K3), before the words
COLUMN_CASES = [(32, 16, 16), (32, 8, 4), (64, 4, 8), (96, 4, 4)]
# (D, H, aligned): no room for words; the general geometry keeps them
GENERAL_CASES = [
    (160, 5, 16),  # 40 words of 4: past 32 lanes
    (132, 4, 16),  # 33 words
    (48, 4, 4),  # 48 single columns on a 4-byte view
    (128, 4, 8),  # 64 words of 2 on an 8-byte view
    (34, 17, 16),  # 17 heads of 2: past MAX_PARTIALS
    (40, 20, 16),
    (40, 8, 8),  # an 8-byte view: 8-byte words ran slower than the general geometry
    (48, 4, 8),
    (20, 4, 4),  # a 4-byte view: single columns ran slower
    (30, 3, 16),  # D % 4 != 0: no 16-byte word divides the row
]


@pytest.mark.parametrize("width,heads,aligned,want", RULE_CASES)
def test_softmax_spmm_words_rule(width, heads, aligned, want):
    cols, lanes, partials, aligned_sums, hi, k2, k3 = want
    g = ca.softmax_spmm_words(width, heads, aligned)
    assert (g.cols, g.lanes, g.partials, g.aligned, g.lo, g.hi) == (cols, lanes, partials, aligned_sums, 1, hi)
    # whole words fill the row: no word is cut by the row's end
    assert width % g.cols == 0 and g.lanes * g.cols >= width and g.lanes >= heads
    assert ca.softmax_spmm_kind(width, heads, aligned) == k2
    assert ca.softmax_spmm_kind(width, heads, aligned, backward=True) == k3
    assert ca.softmax_spmm_columns(width, heads, aligned) == "words"
    geometry = ca.softmax_spmm_geometry(width, heads, aligned)
    if k2 == "words":
        assert tuple(geometry) == ("words", cols, lanes, WARP // lanes, EDGE_GROUP)
    # the bf16 stream keeps its own rule
    assert ca.softmax_spmm_columns(width, heads, aligned, itemsize=2) != "words"


@pytest.mark.parametrize("width,heads,aligned", COLUMN_CASES)
def test_v_columns_come_before_the_words(width, heads, aligned):
    assert ca.softmax_spmm_columns(width, heads, aligned) == "adjacent"
    assert ca.softmax_spmm_kind(width, heads, aligned, backward=True) == "columns"
    assert ca.softmax_spmm_kind(width, heads, aligned) in ("words16", "columns")


@pytest.mark.parametrize("width,heads,aligned", GENERAL_CASES)
def test_general_geometry_keeps_what_the_words_cannot_hold(width, heads, aligned):
    assert ca.softmax_spmm_words(width, heads, aligned) is None
    assert ca.softmax_spmm_columns(width, heads, aligned) == "strided"
    assert ca.softmax_spmm_geometry(width, heads, aligned).kind == "general"
    assert ca.softmax_spmm_kind(width, heads, aligned) == "general"
    assert ca.softmax_spmm_kind(width, heads, aligned, backward=True) == "general"


def heads_a_word(width, heads, cols):
    """The most heads a word of ``cols`` columns touches over a row's words
    (``heads_a_word`` in ``csrc/csr_softmax_spmm.cu``)."""
    dh = width // heads
    return max((c0 + cols - 1) // dh - c0 // dh + 1 for c0 in range(0, width, cols))


def _cases(source, name, pattern):
    body = re.search(rf"#define {name}\(CASE\)(.*?)\n\n", (CSRC / source).read_text(), re.S).group(1)
    return set(re.findall(pattern, body))


def test_softmax_spmm_words_rule_follows_the_kernels_constants():
    """The rule's constants and column choice are the header's; every
    (W, K) the rule gives K2's forward and every (W, P, ALIGNED) it gives
    K3 for a D <= 512 at 16-, 8- and 4-byte alignment is an instantiation of
    its source, each with whole words."""
    heads_text = (CSRC / "word_heads.cuh").read_text()

    def constant(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert constant(heads_text, "kMaxPartials") == ca.MAX_PARTIALS
    assert constant(heads_text, "kMaxLanes") == WARP
    assert "width % 4 != 0 || aligned % 16 != 0" in heads_text and ca.F32_WORD_COLUMNS == 4
    source = (CSRC / ca.SOURCE).read_text()
    assert constant(source, "kEdgeGroup") == EDGE_GROUP
    forward = {(4, int(k)) for k in _cases(ca.SOURCE, "F32_SPAN_CASES", r"CASE\((\d+)\)")}
    backward = {(int(w), int(p), a == "true")
                for w, p, a in _cases(ca.BACKWARD_SOURCE, "K3_WORD_CASES", r"CASE\((\d+), (\d+), (true|false)\)")}
    given_fwd, given_bwd = set(), set()
    for d in range(1, ca.MAX_WIDTH + 1):
        for h in range(1, d + 1):
            if d % h:
                continue
            for aligned in (16, 8, 4):
                g = ca.softmax_spmm_words(d, h, aligned)
                if g is None:
                    continue
                assert g.cols == 4 and d % 4 == 0 and aligned == 16, (d, h, aligned, g)
                given_bwd.add((g.cols, g.partials, g.aligned))
                if ca.softmax_spmm_kind(d, h, aligned) == "words":
                    given_fwd.add((g.cols, heads_a_word(d, h, g.cols)))
    assert given_bwd == backward
    assert given_fwd == forward  # K = 1, a word inside one head, is the 16-byte words' of one head


# --- the kernels' orders, emulated ----------------------------------------------


class _Lanes:
    """A row's L lanes of W columns: each column's head, and each word's
    head slots (the heads h0 .. h0 + K - 1 from its first column's). A word
    the row's end would cut is refused: the kernels load and store whole
    words, so such a word would reach into the next row."""

    def __init__(self, width, heads, geo):
        self.geo, self.width, self.heads = geo, width, heads
        w, lanes = geo.cols, geo.lanes
        if width % w:
            raise ValueError(f"{w}-column words cut a {width}-column row")
        cols = np.arange(lanes * w).reshape(lanes, w)
        self.live = cols < width
        dh = width // heads
        self.col_head = np.where(self.live, cols // dh, 0)
        self.k = heads_a_word(width, heads, w)
        first = self.col_head[:, :1]
        self.slot_head = np.minimum(first + np.arange(self.k), heads - 1)  # [lanes, K]
        self.of = self.col_head - first  # each column's head slot

    def words(self, x):
        """[N, D] as [N, L, W] (zeros past D)."""
        n = x.shape[0]
        pad = np.zeros((n, self.geo.lanes * self.geo.cols - self.width), np.float32)
        return np.concatenate([x, pad], axis=1).reshape(n, self.geo.lanes, self.geo.cols)

    def head_sums(self, a, b):
        """[N, H] per-head sums of a * b over [N, D] rows in the kernels'
        order: a lane's partials in column order (a product into its
        column's head), then the butterfly over the row's lanes (offsets 1,
        2, ..., L / 2), whose pairs are the reduce-scatter's; a lane holding
        another head adds an exact 0."""
        prod = self.words(a * b)
        n, lanes = prod.shape[:2]
        part = np.zeros((n, lanes, self.heads), np.float32)
        for i in range(self.geo.cols):
            for h in range(self.heads):
                part[:, :, h] += np.where(self.col_head[:, i] == h, prod[:, :, i], np.float32(0))
        offset = 1
        while offset < lanes:
            part = part + part[:, np.arange(lanes) ^ offset]
            offset *= 2
        return part[:, 0]


def _rows(bounds):
    """Each edge's row (-1 for an edge no range covers)."""
    e = int(bounds.max()) if bounds.size else 0
    row = np.full(e, -1)
    for r, (lo, hi) in enumerate(bounds.T):
        row[lo:hi] = r
    return row


def words_forward(scores, values, bounds, mask, heads, geo):
    """K2's forward in the word geometry, in numpy f32: per row, its range's
    edges in edge order; each lane takes the online step of each head its
    word touches (``m' = max(m, s)``, ``alpha = exp(m - m')``, ``p = exp(s -
    m')``, ``l = l alpha + p``), each column ``acc = acc alpha + p v`` with
    its head's ``alpha`` and ``p``; a masked edge or a slot past the row
    keeps the state. ``out = acc / (l + 1e-16)``; the lane of a head's first
    column gives ``ml``. Returns ``(out [N, D], ml [2H, N])``."""
    width = values.shape[1]
    lanes = _Lanes(width, heads, geo)
    n = bounds.shape[1]
    start, end = bounds[0].astype(np.int64), bounds[1].astype(np.int64)
    length = np.maximum(end - start, 0)
    m = np.full((n, geo.lanes, lanes.k), ca.NEG, np.float32)
    l = np.zeros((n, geo.lanes, lanes.k), np.float32)
    acc = np.zeros((n, geo.lanes, geo.cols), np.float32)
    pick = np.broadcast_to(lanes.of, acc.shape)
    for t in range(int(length.max(initial=0))):
        inside = t < length
        e = np.where(inside, start + t, 0)
        live = (inside & mask[e])[:, None, None]
        x = scores[e][:, lanes.slot_head]  # [N, L, K]
        v = lanes.words(values[e])
        m_new = np.maximum(m, x)
        alpha = np.exp(m - m_new)
        p = np.exp(x - m_new)
        l = np.where(live, l * alpha + p, l)
        acc = np.where(live, acc * np.take_along_axis(alpha, pick, 2) + np.take_along_axis(p, pick, 2) * v, acc)
        m = np.where(live, m_new, m)
    out = (acc / (np.take_along_axis(l, pick, 2) + np.float32(ca.EPS))).reshape(n, -1)[:, :width]
    ml = np.zeros((2 * heads, n), np.float32)
    first = lanes.live & (np.arange(geo.lanes * geo.cols).reshape(geo.lanes, geo.cols) % (width // heads) == 0)
    for lane, i in zip(*np.nonzero(first)):
        h, k = lanes.col_head[lane, i], lanes.of[lane, i]
        ml[h], ml[heads + h] = m[:, lane, k], l[:, lane, k]
    return out, ml


def general_forward(scores, values, bounds, mask, heads):
    """K2's general geometry (``csrc/softmax_general.cuh``) in numpy f32:
    each column its head's online step an edge, in edge order."""
    n, width = bounds.shape[1], values.shape[1]
    head = np.arange(width) // (width // heads)
    start, end = bounds[0].astype(np.int64), bounds[1].astype(np.int64)
    length = np.maximum(end - start, 0)
    m = np.full((n, width), ca.NEG, np.float32)
    l = np.zeros((n, width), np.float32)
    acc = np.zeros((n, width), np.float32)
    for t in range(int(length.max(initial=0))):
        inside = t < length
        e = np.where(inside, start + t, 0)
        live = (inside & mask[e])[:, None]
        x = scores[e][:, head]
        m_new = np.maximum(m, x)
        alpha = np.exp(m - m_new)
        p = np.exp(x - m_new)
        l = np.where(live, l * alpha + p, l)
        acc = np.where(live, acc * alpha + p * values[e], acc)
        m = np.where(live, m_new, m)
    first = np.arange(width) % (width // heads) == 0
    return acc / (l + np.float32(ca.EPS)), np.concatenate([m[:, first].T, l[:, first].T])


def words_backward(scores, values, bounds, mask, ml, out, g, heads, geo):
    """K3 in the word geometry, in numpy f32: per row ``delta``, the head
    sums of ``out * g``; per edge of its range the head sums of ``values *
    g``, ``attn = exp(s - m) / (l + 1e-16)`` once a head, ``dscores = attn
    (<v, g> - delta)``, ``dvalues = attn g`` with each column's head's
    weight; exactly 0 on masked edges and on the edges no range covers.
    Returns ``(dscores [E, H], dvalues [E, D])``."""
    e_all, width = values.shape
    lanes = _Lanes(width, heads, geo)
    delta = lanes.head_sums(out, g)
    row = _rows(bounds)
    row = np.concatenate([row, np.full(e_all - len(row), -1)])
    live = (row >= 0) & mask
    r = np.maximum(row, 0)
    m, l = ml[:heads].T[r], ml[heads:].T[r]
    with np.errstate(over="ignore"):  # edges of no range: not written
        attn = np.where(live[:, None], np.exp(scores - m) / (l + np.float32(ca.EPS)), np.float32(0))
    dot = lanes.head_sums(values, g[r])
    dscores = np.where(live[:, None], attn * (dot - delta[r]), np.float32(0))
    dvalues = np.where(live[:, None], attn[:, np.arange(width) // (width // heads)] * g[r], np.float32(0))
    return dscores, dvalues


def _layout(seed=3):
    """151 sender rows (an odd count): row 0 forty edges, row 1 nine edges
    all masked, rows 2-6 empty, the rest 0-9 edges with a tenth masked;
    a gap of 3 edges no range covers after row 20 and one of 5 after row
    90, and 7 trailing padding edges. Masked edges and gaps carry score
    -1e30, as ``csr_sparse_attention`` masks them. Returns ``(n, bounds [2,
    N], segments [E], mask [E])``; a gap's edges have their row's segment
    before it (sorted) and are masked."""
    r = np.random.default_rng(seed)
    n = 151
    counts = np.concatenate([[40, 9], np.zeros(5, int), r.integers(0, 10, n - 7)])
    gaps = {20: 3, 90: 5}
    starts, seg, pos = [], [], 0
    for row in range(n):
        starts.append(pos)
        seg += [row] * counts[row]
        pos += counts[row]
        if row in gaps:
            seg += [row] * gaps[row]
            pos += gaps[row]
    ends = [s + c for s, c in zip(starts, counts)]
    seg += [n - 1] * 7
    seg = np.asarray(seg, np.int32)
    bounds = np.asarray([starts, ends], np.int32)
    covered = _rows(bounds)
    covered = np.concatenate([covered, np.full(len(seg) - len(covered), -1)])
    mask = (r.random(len(seg)) >= 0.1) & (covered >= 0)
    mask[bounds[0, 1]:bounds[1, 1]] = False
    return n, bounds, seg, mask


def _inputs(width, heads, seed):
    n, bounds, seg, mask = _layout()
    r = np.random.default_rng(seed)
    scores = np.where(mask[:, None], 3 * r.normal(size=(len(seg), heads)), ca.NEG).astype(np.float32)
    values = r.normal(size=(len(seg), width)).astype(np.float32)
    g = r.normal(size=(n, width)).astype(np.float32)
    return n, bounds, seg, mask, scores, values, g


def _jax(seg, mask, scores, values, g, n, heads):
    """JAX's ``csr_softmax_spmm`` with ``_softmax_spmm_impl``'s ``ml`` (TPU
    interpret mode), and ``_bwd``'s dscores and dvalues on those residuals,
    masked edges given segment N as ``csr_sparse_attention`` hands them
    over."""
    sg = np.where(mask, seg, n).astype(np.int32)
    block_bounds = jax_pa.compute_block_bounds(seg, n, num_real_edges=len(seg))
    args = (jnp.asarray(scores), jnp.asarray(values), jnp.asarray(sg), jnp.asarray(block_bounds), n)
    chunks = jax_pa.compute_max_chunks_bounds(block_bounds)
    with pltpu.force_tpu_interpret_mode():
        out = jax_pa.csr_softmax_spmm(*args, max_chunks=chunks)
        _, ml = jax_pa._softmax_spmm_impl(*args, heads, jax_pa.BLOCK_NODES, jax_pa.BLOCK_EDGES, chunks)
    ds, dv, _, _ = jax_pa._bwd(n, jax_pa.BLOCK_NODES, jax_pa.BLOCK_EDGES, chunks, "f32",
                               (args[0], args[1], args[2], ml, out), jnp.asarray(g))
    return tuple(np.array(x) for x in (out, ml, ds, dv))


# (D, H, aligned) the words take in K2 or K3: 40 x 8, 48 x 4, 96 x 3 (the
# partitioned transformer's widths and the batch's), words across heads of
# 9, D % 8 == 4, heads of 1 (a word spans 4 heads)
ORDER_CASES = [(40, 8, 16), (48, 4, 16), (96, 3, 16), (36, 4, 16), (20, 4, 16), (16, 16, 16)]


@pytest.mark.parametrize("width,heads,aligned", ORDER_CASES)
def test_words_order_matches_jax(width, heads, aligned):
    """Both orders at 1e-5 of JAX's K2 and ``_bwd`` and of the port's plain
    versions, the forward bit-equal to the general geometry's order; rows
    without a live edge give out 0, m -1e30, l 0; masked edges, gaps and
    padding get exactly 0."""
    n, bounds, seg, mask, scores, values, g = _inputs(width, heads, seed=width * heads + aligned)
    geo = ca.softmax_spmm_words(width, heads, aligned)
    out, ml = words_forward(scores, values, bounds, mask, heads, geo)
    general_out, general_ml = general_forward(scores, values, bounds, mask, heads)
    assert np.array_equal(out, general_out) and np.array_equal(ml, general_ml)
    want, want_ml, want_ds, want_dv = _jax(seg, mask, scores, values, g, n, heads)
    np.testing.assert_allclose(out, want, rtol=ORDER_RTOL, atol=ORDER_ATOL)
    np.testing.assert_allclose(ml, want_ml, rtol=ORDER_RTOL, atol=ORDER_ATOL)
    ts, tv, tseg, tb, tm, tg = (torch.from_numpy(x) for x in (scores, values, seg, bounds, mask, g))
    plain, plain_ml = ca.csr_softmax_spmm(ts, tv, tseg, tb, tm)
    np.testing.assert_allclose(out, plain.numpy(), rtol=ORDER_RTOL, atol=ORDER_ATOL)
    np.testing.assert_allclose(ml, plain_ml.numpy(), rtol=ORDER_RTOL, atol=ORDER_ATOL)
    empty = np.flatnonzero(bounds[0] == bounds[1])
    assert len(empty) >= 5 and (out[[1, *empty]] == 0).all() and (ml[heads:, [1, *empty]] == 0).all()
    assert (ml[:heads, [1, *empty]] == ca.NEG).all()
    ds, dv = words_backward(scores, values, bounds, mask, want_ml, want, g, heads, geo)
    plain_grads = ca.csr_softmax_spmm_backward(ts, tv, tseg, tb, torch.from_numpy(want_ml),
                                               torch.from_numpy(want), tg, tm)
    for got, ref, plain_ref in zip((ds, dv), (want_ds, want_dv), plain_grads):
        np.testing.assert_allclose(got, ref, rtol=ORDER_RTOL, atol=ORDER_ATOL)
        np.testing.assert_allclose(got, plain_ref.numpy(), rtol=ORDER_RTOL, atol=ORDER_ATOL)
        assert (got[~mask] == 0).all()


def test_k3_words_keep_every_lane_to_the_last_shuffle():
    """K3's word kernel lets no lane leave before its last whole-warp
    shuffle (the rows past the last in the last warp included): the
    shuffles name every lane of the warp, and what one reads from a lane
    that has left is undefined, so the card's checks need not show it. The
    planted fault of ``chip_smoke_mutants.py`` that makes such a row leave
    early is caught here."""
    import chip_smoke_mutants as mutants

    source = (CSRC / ca.BACKWARD_SOURCE).read_text()
    assert mutants.returns_before_last_shuffle(source) == []
    _, path, line, faulty = mutants.FAULTS["softmaxwords_k3_surplus_row_leaves_before_a_shuffle"]
    assert path.endswith(ca.BACKWARD_SOURCE) and source.count(line) == 1
    assert mutants.returns_before_last_shuffle(source.replace(line, faulty)) == ["if (!r.has_row) return;"]


def test_emulation_refuses_a_cut_word():
    """16-byte words at D = 30 would cut the eighth lane's word at the
    row's end (columns 28-31 of a 30-column row): the rule takes no words
    there (the general geometry keeps it), and the emulation refuses the
    cut geometry rather than read the next row's columns."""
    assert ca.softmax_spmm_words(30, 3, 16) is None
    cut = ca.softmax_spmm_words(32, 4, 16)._replace(partials=4, aligned=False, hi=8)
    with pytest.raises(ValueError, match="cut"):
        _Lanes(30, 3, cut)

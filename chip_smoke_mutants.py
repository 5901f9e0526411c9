"""How far a planted fault moves two checks of ``chip_smoke.py``: a fault in
K1b or in the fused attention backward moves ``first_step``, the check of the first train step on the
card against the CPU (the readings its per-model gradient limits
``EPD_GRAD_RTOL``, ``TRANSFORMER_GRAD_RTOL`` must sit below); a fault in
the fused f32 kernels' word geometry (``csrc/attention_words.cuh``: a
row's last word read as an idle lane's zeros; ``csrc/word_heads.cuh``: the
head sums' butterfly missing its last level) moves the ``kernel_width`` cases' check against
the plain versions and ``width_first_step`` (the transformer at hidden 48
in 4 heads, first step against the CPU); a fault in the fused bf16
kernels' word geometry (``csrc/csr_attention_bf16_words.cu`` with
``attention_words.cuh``: a row's last bf16 word read as zeros, the head
sums' butterfly missing its last level, part B of the backward reading
the (attn, ds) pair of the wrong head) moves the bf16 kernel phase's word
cases against the plain versions and ``bf16_width_training``'s first step
(the transformer at hidden 48 in 4 heads in bf16, on one 2,048-node
graph, against the CPU in bf16); a fault in
the checkpoint restore moves ``resume_runs``, the check of a resumed run
against an uninterrupted one (the readings ``RESUME_MEDIAN_RTOL`` and the
per-model worst limits must sit below); a fault in the fused attention's
bf16 kernels (``csrc/csr_attention_bf16.cuh``'s 16-byte lanes, the
backward's part B over the transposed CSR in ``csr_attention_bwd_bf16.cu``)
moves the bf16 ``first_step`` (the panels transformer in bf16 on one
2,048-node graph, card and CPU both in bf16: the reading
``BF16_GRAD_RTOL`` must sit below) and the bf16 kernel phase's check
against the plain versions (the share of elements that differ:
``BF16_MISMATCH_SHARE``); a fault in the gradient-accumulation step moves
``grad_accum``, the check of the microbatch step against the concat step
(each microbatch's gradient divided by its own count, a mean of means: the
gradient limits; the normalizer counters opened and closed no more, so
they advance once per microbatch: the counter check); a fault in the ELL
gather's backward moves ``compare_steps``, the check of the first ELL step
against the same step in the model's own layout (the gradient limits);
a fault in the 16-bit stream modes (the 16-bit K1's 16-byte geometry
summing in the data's dtype, K5's bf16 word geometry reading a neighbour
lane's word or dropping each row's last edge, the fused bf16 stream entry
skipping its score rounding) moves the ``stream_dtypes`` phase's checks
(``chip_stream.py``): the hub row of 4,096 unit edges and the one-ulp check
against the plain version, K5's stream against its plain version at the
phase's tolerance, and the check that a stream entry's output differs from
the entry without the stream; a fault in K2's bf16 stream word geometries
(a lane reading its neighbour's word, each row's last edge dropped) moves
K2's stream against its plain version and its geometry cases; a fault in
the f32 K1's 16-byte words (each window's last edge dropped, a lane reading
its neighbour's word) moves the kernel phase's check against the plain
version (``KERNEL_ATOL``) and the f32 geometry cases (the same bits in words
and single columns, the 4,096-edge hub row); a fault in the f32 K2's
16-byte words (a lane reading its neighbour's word, each window's last
live edge dropped) moves K2's kernel-phase check against its plain version
(``SOFTMAX_RTOL``/``ATOL``) at the panels batch and at part 0 of the
unsplit mesh cut, and its geometry cases; a fault in the general geometry
of K2 and K3 (``csrc/softmax_general.cuh``: K2's last column slot dropped,
K3's dot reading a column one stride off, and the forward walk that K2 and
K5 share reading a column one stride off) moves their geometry cases
against the plain versions, the partitioned transformer's first steps at
hidden 48 and 40 against the unpartitioned card step (the fused
attention; ``STEP_LOSS_RTOL``, ``PARTITIONED_TRANSFORMER_GRAD_RTOL``) and
its unsplit first step against the split-edge one (``STEP_LOSS_RTOL``,
``TRANSFORMER_GRAD_RTOL``), which cannot see a fault in the shared walk;
a fault in K2's and K3's word geometry (``csrc/csr_softmax_spmm.cu``'s
words that span heads reading a row's last word as an idle lane's;
``csrc/csr_softmax_spmm_bwd.cu``: the same in K3, the select's and the
ALIGNED head sums summing the wrong heads, a gap left unzeroed when rows
share a warp, the last warp's surplus row leaving before the shuffles)
moves the geometry cases, the kernel phase's cases at part 0 of the
unsplit mesh cut and the card test ``test_softmax_spmm_words_match_plain``
(an odd row count, gaps), on memory poisoned with NaN; a lane leaving
before the last whole-warp shuffle, undefined on the card, is caught by
the source check ``returns_before_last_shuffle`` (the CPU test
``test_k3_words_keep_every_lane_to_the_last_shuffle`` runs it).

For each fault the tree is copied to a temporary directory, one line of a
source is replaced there, the kernels are built from the copy and the check
runs with its limits lifted: ``first_step`` on the flagship batch (K1b
faults, EPD 15 x 128) or the panels batch (faults in
``csrc/csr_attention_bwd.cu``, transformer 15 x 128; faults in the word
geometry, the ``kernel_width`` cases and the same transformer at
``hidden_size`` 48, whose 4 heads of 12 in the (N, Dh, H) view take it
with 16 lanes of one 4-column word, lanes 12-15 idle); ``resume_runs`` on
the in-memory trajectories of the checkpoint phases. One JSON line per fault. The repo itself is never changed. Needs
one CUDA card:

    python3 chip_smoke_mutants.py [name prefix]

A name prefix (``k1b``, ``k1f32``, ``k2f32``, ``general``, ``softmaxwords``, ``attn``,
``width``, ``resume``, ``bf16``, ``bf16words``, ``microbatch``, ``ell``,
``stream``) runs those faults only. K2's and K3's faults are caught by their kernel phases
against their plain versions, and the general geometry's also by the
partitioned transformer's checks: no path of the unpartitioned models runs
them.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
K1 = "graphphysics_torch/csrc/csr_segment_sum.cu"
ATTN = "graphphysics_torch/csrc/csr_attention_bwd.cu"
K1B_LIVE = "if (live) live = bounds[r] <= e && e < bounds[num_rows + r];"
ATTN_DS = "ds[p] = attn[p] * (vg[p] - delta[p]);"
ATTN_DK = "add_row<V, GEN>(dk, j, geo, r, dkr);"
ATTN_DQ = "for (int i = 0; i < V; ++i) dqa[i] += ds[i % NP] * scale * kc[i];"
WORDS = "graphphysics_torch/csrc/attention_words.cuh"
WORD_LOAD = "  if (!r.live) {"
WORD_HEADS = "graphphysics_torch/csrc/word_heads.cuh"  # the head sums, shared with K3's words
WORD_BUTTERFLY = "for (int offset = geo.lo * P; offset < geo.hi; offset <<= 1) {"
BF16_WORDS = "graphphysics_torch/csrc/csr_attention_bf16_words.cu"
BF16_WORDS_PAIR = "const int x = ALIGNED ? i % P : i;"
BF16_WORDS_HEAD = "for (int i = 0; i < W; ++i) head[i] = word_head(geo, r, i);"
BF16_BWD = "graphphysics_torch/csrc/csr_attention_bwd_bf16.cu"
BF16_HEADER = "graphphysics_torch/csrc/csr_attention_bf16.cuh"
BF16_DK = "dka[i] += d[u][i % NP] * scale * qr[i];"
BF16_DV = "dva[i] += round_to<__nv_bfloat16>(a[u][i % NP] * gr[i]);"
BF16_ROW = "reinterpret_cast<const uint4*>(base + static_cast<int64_t>(j) * geo.width + r.col0);"
BF16_SLOT = "const bool live = t < r.len;"
K1_WORD_SUM = ("acc[2 * i] += f.x;", "acc[2 * i + 1] += f.y;")
K1_F32_ADD = "if (live[u]) add_word<T>(w[u], acc);  // edge order: one edge at a time's additions"
K1_F32_LOAD = "w[u] = *reinterpret_cast<const uint4*>(data + e * width + col);"
K2 = "graphphysics_torch/csrc/csr_softmax_spmm.cu"
K2_WORD = "w[u] = *reinterpret_cast<const Word*>(values + e * width + col0);"
K2_SLOT = "if (!live[u]) continue;"
K2_STEP = "        online_step<W>(m1, l1, a1, x[u], v);\n"  # the words of one head, not those that span heads
K2_F32_STEP = K2_STEP + "        if (live[u]) {"
K2_SPAN_RETURN = "  if (row >= num_rows || col0 >= width) return;  // no shuffles: a lane past its row leaves at once"
K3 = "graphphysics_torch/csrc/csr_softmax_spmm_bwd.cu"
K3_LIVE = "  r.live = r.col0 < geo.width;"
K3_HEADS = "  const Hd h = make_heads<W, P, ALIGNED>(geo, r);"
K3_HD = "  using Hd = Heads<W, P, ALIGNED>;"
K3_GAP = "  zero_span<W>(dscores, dvalues, r.end < r.start ? r.start : r.end, next, geo, r.sub);"
K3_WORDS = "  const bool words = r.has_row && r.live;"
K5 = "graphphysics_torch/csrc/csr_softmax_spmm_pair.cu"
GENERAL = "graphphysics_torch/csrc/softmax_general.cuh"
GENERAL_OUT = "out[row * width + c] = acc[i] / (l[i] + kEps);"
GENERAL_DOT = "ve[i] = c < width ? v[c] : 0.0f;"
GENERAL_WALK = "ve[i] = c < width ? to_f32(v[c]) : 0.0f;"
K5_WORD = "w[u] = *reinterpret_cast<const Word*>((in_a ? a.values : b.values) + e * width + col0);"
K5_SLOT = "if (!live[u]) continue;"
BF16_FWD = "graphphysics_torch/csrc/csr_attention_bf16.cu"
BF16_SCORE_ROUND = "for (int p = 0; p < NPR; ++p) s[u][p] = round_to<__nv_bfloat16>(s[u][p]);"
MICRO = "graphphysics_torch/training/microbatch.py"
MICRO_BACKWARD = "        ls.backward()  # frees this microbatch's graph before the next forward"
MICRO_DIVIDE = "                p.grad.div_(denom)"
MICRO_OPEN = "    old = open_counters(sim)"
MICRO_CLOSE = "    close_counters(sim, old)"
ELL = "graphphysics_torch/ops/ell_ops.py"
ELL_TWIN = "ell_segment_sum(g.index_select(0, twin_perm), ctx.ell_degree)"
CKPT = "graphphysics_torch/training/checkpoint.py"
OPT_LOAD = '    trainer.optimizer.load_state_dict(ckpt["optimizer"])'
WEIGHTS_LOAD = "    load_reference_checkpoint(sim, ckpt)"
ZERO_NORMALIZERS = (WEIGHTS_LOAD + "\n    for n, b in sim.named_buffers():\n"
                    "        if \"_normalizer.\" in n:\n            b.zero_()")
# name -> (model, source, line, faulty line), or (model, source, lines,
# faulty lines) with tuples; graph 5 of the panels batch is the one with
# empty softmax rows
FAULTS = {
    "k1b_zero_graph5": ("epd", K1, K1B_LIVE, K1B_LIVE[:-1] + " && r / 2048 != 5;"),
    "k1b_drop_last_edge": ("epd", K1, K1B_LIVE, K1B_LIVE.replace("e < bounds", "e + 1 < bounds")),
    "attn_ds_x1.001": ("transformer", ATTN, ATTN_DS, ATTN_DS.replace("= attn", "= 1.001f * attn")),
    "attn_ds_x1.01": ("transformer", ATTN, ATTN_DS, ATTN_DS.replace("= attn", "= 1.01f * attn")),
    # graph 5's senders add nothing to dk
    "attn_dk_zero_graph5": ("transformer", ATTN, ATTN_DK, "if (r.row / 2048 != 5) " + ATTN_DK),
    # each row's last edge adds nothing to dq
    "attn_dq_drop_last_edge": ("transformer", ATTN, ATTN_DQ, ATTN_DQ.replace(
        "+= ds[i % NP] * scale * kc[i];", "+= first + t + 1 < r.len ? ds[i % NP] * scale * kc[i] : 0.0f;")),
    # the word geometry reads its row's last word as zeros, as an idle
    # lane's (width 48 in 4 heads: lane 11 of 16, columns 44-47; 40: lane 9,
    # columns 36-39; 96: lane 23), in both kernels
    "width_drop_tail_columns": ("width", WORDS, WORD_LOAD, "  if (!r.live || r.col0 + W >= geo.width) {"),
    # the word geometry's head sums without the butterfly's last level: each
    # half of a head's lanes sums its own half of the head (48 x 4 and 40 x 8
    # in the model's view: lanes 0-7 and 8-15; 96 x 3: 0-15 and 16-31, and
    # contiguous a head's lanes 0-3 and 4-7), in both kernels
    "width_head_sums_miss_last_level": ("width", WORD_HEADS, WORD_BUTTERFLY, WORD_BUTTERFLY.replace(
        "offset < geo.hi;", "offset < geo.hi / 2;")),
    # the bf16 word geometry (csr_attention_bf16_words.cu, attention_words.cuh
    # with T = bf16) reads its row's last word as zeros, as an idle lane's
    # (48 x 4 on 16-byte words: lane 5 of 8, columns 40-47; 20 x 4 on 8-byte
    # words: lane 4, columns 16-19), in the forward and both backward parts;
    # the f32 words keep theirs
    "bf16words_drop_tail_word": ("bf16words", WORDS, WORD_LOAD,
                                 "  if (!r.live || (sizeof(T) == 2 && r.col0 + W >= geo.width)) {"),
    # the word geometry's head sums without the butterfly's last level (the
    # f32 words' fault, read by the bf16 checks: 48 x 4 on 16-byte words,
    # lanes 0-3 and 4-7 each sum their own half of a head)
    "bf16words_head_sums_miss_last_level": ("bf16words", WORD_HEADS, WORD_BUTTERFLY, WORD_BUTTERFLY.replace(
        "offset < geo.hi;", "offset < geo.hi / 2;")),
    # part B of the bf16 word geometry's backward takes each column's (attn,
    # ds) pair from the next head's slot (an aligned lane's P pairs)
    "bf16words_gather_rows_read_wrong_head": ("bf16words", BF16_WORDS, BF16_WORDS_PAIR, BF16_WORDS_PAIR.replace(
        "i % P :", "(i + 1) % P :")),
    # the same fault in the select (96 x 3 in both views, 48 x 4
    # contiguous): part B loads each column's (attn, ds) pair from the next
    # head's slot
    "bf16words_gather_rows_select_wrong_head": ("bf16words", BF16_WORDS, BF16_WORDS_HEAD, BF16_WORDS_HEAD.replace(
        "word_head(geo, r, i);", "(word_head(geo, r, i) + 1) % geo.heads;")),
    # the bf16 backward sums dk and dv in bf16 instead of f32: every partial
    # sum of a gather row rounded to bf16
    "bf16_dkdv_summed_in_bf16": ("bf16transformer+kernel", BF16_BWD, (BF16_DK, BF16_DV), (
        "dka[i] = round_to<__nv_bfloat16>(dka[i] + d[u][i % NP] * scale * qr[i]);",
        "dva[i] = round_to<__nv_bfloat16>(dva[i] + round_to<__nv_bfloat16>(a[u][i % NP] * gr[i]));")),
    # a 16-byte lane reads its neighbour's 8 columns of each gathered row
    "bf16_row_read_from_neighbour_lane": ("bf16transformer+kernel", BF16_HEADER, BF16_ROW,
                                          BF16_ROW.replace("r.col0)", "(r.col0 ^ V))")),
    # part B walks each gather row's slots of the transposed CSR one short:
    # every node's last gathering edge adds nothing to its dk and dv
    "bf16_gather_rows_drop_last_slot": ("bf16transformer+kernel", BF16_BWD, BF16_SLOT,
                                        BF16_SLOT.replace("t < r.len", "t + 1 < r.len")),
    # the 16-bit K1's 16-byte geometry keeps its sum in the data's dtype:
    # every partial sum rounded to bf16 / f16
    "stream_k1_sums_in_16bit": ("stream", K1, K1_WORD_SUM, (
        "acc[2 * i] = to_f32(from_f32<T>(acc[2 * i] + f.x));",
        "acc[2 * i + 1] = to_f32(from_f32<T>(acc[2 * i + 1] + f.y));")),
    # K5's bf16 stream, word geometries: a lane reads its neighbour lane's
    # word of each edge's values
    "stream_k5_reads_neighbour_word": ("stream", K5, K5_WORD, K5_WORD.replace("col0);", "(col0 ^ W));")),
    # K5's bf16 stream, word geometries: each row's last edge slot (set b's
    # last edge, or set a's where b has none) is dropped from the merge
    "stream_k5_drops_last_slot": ("stream", K5, K5_SLOT,
                                  "if (!live[u] || t0 + u + 1 == len) continue;"),
    # the f32 K1's 16-byte words: each window's last edge adds nothing (the
    # 16-bit entries keep it)
    "k1f32_words_drop_window_last_edge": ("k1f32", K1, K1_F32_ADD, K1_F32_ADD.replace(
        "if (live[u])", "if (live[u] && (sizeof(T) == 2 || u + 1 < kEdgeGroup))")),
    # the f32 K1's 16-byte words: a lane reads its neighbour lane's word of
    # each edge row
    "k1f32_reads_neighbour_word": ("k1f32", K1, K1_F32_LOAD, K1_F32_LOAD.replace(
        "+ col);", "+ (sizeof(T) == 4 ? col ^ kF32WordCols : col));")),
    # K2's bf16 stream, word geometries: a lane reads its neighbour lane's
    # word of each edge's values
    "stream_k2_reads_neighbour_word": ("stream", K2, K2_WORD, K2_WORD.replace("col0);", "(col0 ^ W));")),
    # K2's bf16 stream, word geometries: each row's last edge slot is
    # dropped from the softmax (the f32 words keep it)
    "stream_k2_drops_last_slot": ("stream", K2, K2_SLOT, "if (!live[u] || e0 + u + 1 == end) continue;"),
    # the f32 K2's 16-byte words: a lane reads its neighbour lane's word of
    # each edge's values (the bf16 stream's words keep theirs)
    "k2f32_reads_neighbour_word": ("k2f32", K2, K2_WORD, K2_WORD.replace(
        "col0);", "(sizeof(T) == 4 ? col0 ^ W : col0));")),
    # the f32 K2's 16-byte words: each window's last live edge takes no
    # online step
    "k2f32_drops_window_last_live_edge": ("k2f32", K2, K2_F32_STEP, (
        K2_STEP + "        if (live[u] && [&] { for (int k = u + 1; k < kEdgeGroup; ++k) if (live[k]) return true; "
        "return false; }()) {")),
    # K2's general geometry (one edge set; K5's two keep theirs): a lane's
    # last column slot past the first 32 columns writes 0 (D = 40 in 8
    # heads: columns 32-39)
    "general_k2_drops_tail_columns": ("general", GENERAL, GENERAL_OUT,
                                      "out[row * width + c] = NS == 1 && i > 0 && i + 1 == NC ? 0.0f : "
                                      "acc[i] / (l[i] + kEps);"),
    # the forward walk K2 and K5 share, unguarded: each edge's value of a
    # column is read one stride (32 columns) off where one is there (D = 40:
    # lanes 0-7 of the first slot read columns 32-39), in K2's general
    # geometry and K5's alike
    "general_walk_reads_column_one_stride_off": ("general", GENERAL, GENERAL_WALK,
                                                 "ve[i] = c < width ? to_f32(v[c + kLanes < width ? c + kLanes : c])"
                                                 " : 0.0f;"),
    # K3's general geometry (K5's backward keeps its own): each edge's
    # values . g dot reads a column one stride (32 columns) off where one is
    # there (D = 48: lanes 0-15 of the first slot read columns 32-47)
    "general_k3_reads_column_one_stride_off": ("general", GENERAL, GENERAL_DOT,
                                               "ve[i] = c < width ? v[kZeroFill && c + kLanes < width ? "
                                               "c + kLanes : c] : 0.0f;"),
    # K2's words that span heads (forward_span_words) read their row's last
    # word as an idle lane's: that lane leaves, its columns unwritten (40 x
    # 8: lane 9 of 16, columns 36-39; 36 x 4: lane 8, columns 32-35); the
    # 16-byte words of one head keep theirs
    "softmaxwords_k2_drops_tail_word": ("softmaxwords", K2, K2_SPAN_RETURN, K2_SPAN_RETURN.replace(
        "col0 >= width)", "col0 + W >= width)")),
    # K3's word geometry reads its row's last word as zeros, as an idle
    # lane's: no value, g or out word, no dvalues store (48 x 4: lane 11 of
    # 16, columns 44-47; 96 x 3: lane 23 of 32)
    "softmaxwords_k3_drops_tail_word": ("softmaxwords", K3, K3_LIVE, "  r.live = r.col0 + W < geo.width;"),
    # K3's select adds each column's product into the next head's partial
    # (48 x 4, 40 x 8, 36 x 4, 20 x 4); the weights read back keep their
    # heads
    "softmaxwords_k3_select_wrong_head": ("softmaxwords", K3, K3_HEADS, (
        "  Hd h = make_heads<W, P, ALIGNED>(geo, r);\n"
        "  if (!ALIGNED) for (int i = 0; i < W; ++i) h.column[i] = (h.column[i] + 1) % geo.heads;")),
    # the ALIGNED variant (96 x 3: a head's 8 lanes): the butterfly runs over
    # 16 lanes, two heads' columns summed as one head's
    "softmaxwords_k3_aligned_wrong_heads": ("softmaxwords", K3, K3_HD,
                                            K3_HD + "\n  if (ALIGNED && geo.hi < geo.lanes) geo.hi *= 2;"),
    # with several rows a warp, only each warp's first row zeroes the edges
    # after its range (the trailing padding's row of an even row count is
    # a warp's second at 16 lanes a row)
    "softmaxwords_k3_gap_unzeroed_when_rows_share_a_warp": ("softmaxwords", K3, K3_GAP, (
        "  if (geo.lanes == kLanes || r.row % (kLanes / geo.lanes) == 0)\n  " + K3_GAP.strip())),
    # the last warp's row past the last leaves before the head sums and the
    # warp's largest range length, which every lane of the warp must reach
    "softmaxwords_k3_surplus_row_leaves_before_a_shuffle": ("softmaxwords", K3, K3_WORDS, (
        "  if (!r.has_row) return;\n" + K3_WORDS)),
    # the fused bf16 stream entry skips its score rounding: the bf16 entry's
    # function again
    "stream_fused_skips_score_rounding": ("stream", BF16_FWD, BF16_SCORE_ROUND, BF16_SCORE_ROUND.replace(
        "round_to<__nv_bfloat16>(s[u][p])", "s[u][p]")),
    # each microbatch's gradient divided by its own count, then averaged
    "microbatch_mean_of_means_epd": ("accum_epd", MICRO, (MICRO_BACKWARD, MICRO_DIVIDE), (
        "        (ls / torch.clamp(c, min=1.0) / len(micro)).backward()", "                pass")),
    "microbatch_mean_of_means_transformer": ("accum_transformer", MICRO, (MICRO_BACKWARD, MICRO_DIVIDE), (
        "        (ls / torch.clamp(c, min=1.0) / len(micro)).backward()", "                pass")),
    # the counters not opened and closed: every microbatch's fold counts
    "microbatch_counter_per_microbatch": ("accum_epd", MICRO, (MICRO_OPEN, MICRO_CLOSE),
                                          ("    old = None", "    del old")),
    # the ELL gather's backward sums g over the owner's own slots, without
    # the twin permutation
    "ell_twin_identity": ("ell", ELL, ELL_TWIN, "ell_segment_sum(g, ctx.ell_degree)"),
    # the resumed run starts with fresh AdamW moments and step counts
    "resume_fresh_optimizer_epd": ("epd", CKPT, OPT_LOAD, "    pass"),
    "resume_fresh_optimizer_transformer": ("transformer", CKPT, OPT_LOAD, "    pass"),
    # the resumed run starts with zero normalizer statistics
    "resume_zero_normalizers_epd": ("epd", CKPT, WEIGHTS_LOAD, ZERO_NORMALIZERS),
    "resume_zero_normalizers_transformer": ("transformer", CKPT, WEIGHTS_LOAD, ZERO_NORMALIZERS),
}


def read_resume_fault(model: str, name: str) -> dict:
    """``resume_runs`` with lifted limits."""
    import chip_smoke as cs
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    cs.RESUME_MEDIAN_RTOL = cs.ADAM_STEP_MAX = math.inf
    if model == "epd":
        param, make_traj = cs.load_config(cs.CYLINDER_CONFIG), cylinder_trajectory
    else:
        param, make_traj = cs.load_config(cs.PANELS_CONFIG), panels_trajectory
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = cs.memory_datasets(param, make_traj, 0, tmp, cs.CKPT_TRAJECTORIES)
        readings = cs.resume_runs(name, param, train_ds, val_ds, {}, {}, 0, tmp, math.inf)[0]
    keep = ("resume_param_rel_err_worst", "resume_worst_param", "resume_param_rel_err_median",
            "resume_roundoff_leaf_max_abs_diff", "rerun_param_rel_err_worst",
            "rerun_param_rel_err_median", "rerun_roundoff_leaf_max_abs_diff")
    return {"fault": name, **{k: readings[k] for k in keep}}


def read_accum_fault(model: str, name: str) -> dict:
    """``grad_accum`` with its gradient, loss and memory limits lifted; the
    counter check stays, and a fault it catches is reported by its
    message."""
    import chip_smoke as cs

    cs.STEP_LOSS_RTOL = cs.STEP_ROUNDOFF_SHARE = cs.ACCUM_PEAK_SHARE = math.inf
    if model == "accum_epd":
        param, graphs = cs.load_config(cs.CYLINDER_CONFIG), cs.flagship_graphs(0)
    else:
        param, graphs = cs.load_config(cs.PANELS_CONFIG), cs.panels_graphs(200)
    try:
        result = cs.grad_accum(name, param, graphs, {}, {}, 0, math.inf)
    except AssertionError as err:
        return {"fault": name, "caught_by": str(err)[:400]}
    keep = ("loss_rel_err", "grad_rel_err_worst", "grad_worst_param", "grad_rel_err_median",
            "relu_sign_flips", "normalizer_counters")
    return {"fault": name, **{k: result[k] for k in keep}}


def read_ell_fault(name: str) -> dict:
    """``compare_steps`` with its limits lifted: the first ELL step against
    the own layout's on the ELL pipeline's first batch, for both
    families."""
    import tempfile

    import chip_smoke as cs
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    cs.STEP_LOSS_RTOL = math.inf
    out = {"fault": name}
    for label, config, make_traj in (("epd", cs.CYLINDER_CONFIG, cylinder_trajectory),
                                     ("transformer", cs.PANELS_CONFIG, panels_trajectory)):
        param = cs.load_config(config)
        ell = cs.with_dataset(param, edge_layout="ell")
        with tempfile.TemporaryDirectory() as tmp:
            ell_ds, _ = cs.memory_datasets(ell, make_traj, 0, tmp, n_traj=2)
            own_ds, _ = cs.memory_datasets(param, make_traj, 0, tmp, n_traj=2)
            batches = [GraphLoader(ds, batch_size=8, shuffle=True, seed=0).peek() for ds in (ell_ds, own_ds)]
        try:
            step = cs.compare_steps(name, "layout", (ell, batches[0]), (param, batches[1]), 0, math.inf)
        except AssertionError as err:  # the statistics check stays
            step = {"caught_by": str(err)[:400]}
        out.update({f"{label}_{k}": v for k, v in step.items() if k != "layout_tolerance"})
    return out


def read_k1f32_fault(name: str) -> dict:
    """The f32 K1's kernel-phase checks with ``KERNEL_ATOL`` lifted: the
    error against the plain version at the cylinder batch and the aneurysm
    EPD graph, then the geometry cases (widths 128, 64, 48, 130 in words
    and single columns, the same bits in both; the 4,096-edge hub row), a
    fault they catch reported by its message."""
    import chip_smoke as cs

    cs.KERNEL_ATOL = math.inf
    out = {"fault": name}
    for label, graph, seed in (("flagship_batch_8x2048", cs.flagship_batch(0), 1),
                               ("aneurysm_epd_66560x524288", cs.random_graph(*cs.ANEURYSM, 100), 2)):
        out[f"plain_max_abs_err_{label}"] = cs.k1_case(label, graph, seed)["max_abs_err"]
    try:
        cs.k1_geometry_cases(cs.flagship_batch(0), 80)
        out["geometry_cases"] = "passed"
    except AssertionError as err:
        out["geometry_cases_caught_by"] = str(err)[:300]
    return out


def read_k2f32_fault(name: str) -> dict:
    """The f32 K2's kernel-phase check with ``SOFTMAX_RTOL``/``ATOL``
    lifted: the error against the plain version at the panels batch and at
    part 0 of the unsplit mesh cut, and the share of outputs outside the
    limits; then the geometry cases at the limits, a fault they catch
    reported by its message."""
    import torch

    import chip_smoke as cs

    tol = {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}
    cs.SOFTMAX_RTOL = cs.SOFTMAX_ATOL = math.inf
    out = {"fault": name}
    for label, graph, seed in (("panels_csr_batch_8x2048", cs.panels_batch(200), 4),
                               ("mesh_16384_part0_of_4_unsplit", cs.unsplit_part0(601), 81)):
        record = cs.k2_case(label, graph, cs.HIDDEN, seed)
        out[f"plain_max_abs_err_{label}"] = record["max_abs_err"]
        out[f"plain_ml_max_abs_err_{label}"] = record["ml_max_abs_err"]
        out[f"geometry_{label}"] = record["geometry"]["kind"]
        # the share of outputs outside the limits, on k2_case's inputs
        from graphphysics_torch.ops import csr_attention as ca

        seg, bounds, mask = (torch.as_tensor(a).to("cuda") for a in (graph.senders, graph.sender_bounds,
                                                                     graph.edge_mask))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        scores = torch.where(mask[:, None], 3 * torch.randn((seg.shape[0], cs.HEADS), generator=gen,
                                                            device="cuda"), torch.full((), ca.NEG, device="cuda"))
        values = torch.randn((seg.shape[0], cs.HIDDEN), generator=gen, device="cuda")
        with torch.no_grad():
            got, _ = ca.csr_softmax_spmm(scores, values, seg, bounds, mask)
            want, _ = ca.csr_softmax_spmm_reference(scores, values, seg, bounds.shape[1], mask)
        out[f"plain_share_outside_tolerance_{label}"] = (~torch.isclose(got, want, **tol)).float().mean().item()
    cs.SOFTMAX_RTOL, cs.SOFTMAX_ATOL = tol["rtol"], tol["atol"]
    try:
        cs.k2_f32_geometry_cases(cs.panels_batch(200), 83)
        out["geometry_cases"] = "passed"
    except AssertionError as err:
        out["geometry_cases_caught_by"] = str(err)[:300]
    return out


def read_general_fault(name: str) -> dict:
    """The general geometry's checks: K2's and K3's geometry cases
    (``K2_F32_GEOMETRY_CASES`` on the panels batch) with
    ``SOFTMAX_RTOL``/``ATOL`` and ``K3_RTOL``/``ATOL`` lifted, each strided
    case's error against its plain version, then the cases at their limits
    (a fault they catch reported by its message); and the partitioned
    transformer's first steps at ``chip_partition.WIDTH_STEPS`` (4 ranks
    sharing the card) with their limits lifted: each layout's against the
    unpartitioned card step (the fused attention; ``STEP_LOSS_RTOL`` and
    ``PARTITIONED_TRANSFORMER_GRAD_RTOL``), and the unsplit step (K2, K3)
    against the split-edge one (K5; ``STEP_LOSS_RTOL`` and
    ``TRANSFORMER_GRAD_RTOL``), each also with ``STEP_ROUNDOFF_SHARE``
    (the key bias's gradient against the largest): each reading and
    whether its check catches the fault."""
    import pickle

    import chip_partition as cp
    import chip_smoke as cs
    from graphphysics_torch.parallel.mesh import launch

    out = {"fault": name}
    limits = (cs.SOFTMAX_RTOL, cs.SOFTMAX_ATOL, cs.K3_RTOL, cs.K3_ATOL)
    batch = cs.panels_batch(200)
    for label, cases in (("k2", cs.k2_f32_geometry_cases), ("k3", cs.k3_f32_geometry_cases)):
        # 1e30, not inf: inf * 0 is NaN, and a plain zero would then fail
        cs.SOFTMAX_RTOL = cs.SOFTMAX_ATOL = cs.K3_RTOL = cs.K3_ATOL = 1e30
        try:
            out[f"{label}_strided_max_abs_err"] = {
                f"{r['width']}x{r['heads']}@{r['aligned']}B": r["max_abs_err"]
                for r in cases(batch, 83) if r["columns"] == "strided"}
        except AssertionError as err:  # bits twice, empty rows, masked zeros stay
            out[f"{label}_lifted_caught_by"] = str(err)[:300]
        cs.SOFTMAX_RTOL, cs.SOFTMAX_ATOL, cs.K3_RTOL, cs.K3_ATOL = limits
        try:
            cases(batch, 83)
            out[f"{label}_geometry_cases"] = "passed"
        except AssertionError as err:
            out[f"{label}_geometry_cases_caught_by"] = str(err)[:300]
    panels = cs.load_config(cs.PANELS_CONFIG)
    mesh = cp.mesh_graph("csr", 601)
    refs = cp.width_references(panels, mesh, 0, 1 + cp.LIGHT_TIMED)
    spec = {"total_steps": 1 + cp.LIGHT_TIMED, "rollouts": {}, "steps": cp.width_cases(panels, mesh, 0)}
    with tempfile.TemporaryDirectory(prefix="general_fault_") as tmp:
        spec_path = os.path.join(tmp, "spec.pkl")
        with open(spec_path, "wb") as f:
            pickle.dump(spec, f)
        ranks = []
        for path in launch(cp.rank_main, cp.PARTS, "cuda", args=(spec_path,), timeout=cp.RANKS_TIMEOUT_S):
            with open(path, "rb") as f:
                ranks.append(pickle.load(f))
    share = cs.STEP_ROUNDOFF_SHARE
    cs.STEP_ROUNDOFF_SHARE = math.inf  # the key bias's gradient, round-off only when sound
    widths, _ = cp.width_checks(ranks, panels["model"]["message_passing_num"], refs, math.inf, math.inf, math.inf)
    cs.STEP_ROUNDOFF_SHARE = share
    for key, width in widths.items():
        for check, grad_rtol in (("split_against_unsplit", cs.TRANSFORMER_GRAD_RTOL),
                                 ("split", cp.PARTITIONED_TRANSFORMER_GRAD_RTOL),
                                 ("unsplit", cp.PARTITIONED_TRANSFORMER_GRAD_RTOL)):
            step = width[check]
            name = check if check == "split_against_unsplit" else f"{check}_against_unpartitioned"
            out[f"{name}_{key}"] = {
                "loss_rel_err": step["first_step_loss_rel_err"],
                "grad_rel_err_worst": step["first_step_grad_rel_err_worst"],
                "worst_param": step["first_step_grad_worst_param"],
                "roundoff_share": step["first_step_roundoff_share"],
                "caught": step["first_step_loss_rel_err"] > cs.STEP_LOSS_RTOL
                or step["first_step_grad_rel_err_worst"] > grad_rtol
                or step["first_step_roundoff_share"] > cs.STEP_ROUNDOFF_SHARE}
    return out


# the calls of K3's word kernel that shuffle across the whole warp
WARP_SHUFFLES = ("warp_max(", "head_sum<", "head_sums<", "read_back<")


def returns_before_last_shuffle(source: str, kernel: str = "backward_words") -> list:
    """The lines of ``kernel``'s body in ``source`` that leave the kernel
    (``return;``) before its last whole-warp shuffle (``WARP_SHUFFLES``): a
    lane that leaves there is missing from shuffles that name it, which the
    card need not show (what a shuffle reads from a lane that has left is
    undefined)."""
    start = source.index(f"{kernel}(const float*")
    body = source[start:source.index("\n}\n", start)]
    last = max(body.rindex(call) for call in WARP_SHUFFLES if call in body)
    return [line.strip() for line in body[:last].splitlines() if re.search(r"\breturn\s*;", line)]


def read_softmax_words_fault(name: str) -> dict:
    """K2's and K3's word geometry's checks, each at its limits on memory
    poisoned with NaN (an output the kernel leaves unwritten shows): the
    geometry cases (``K2_F32_GEOMETRY_CASES`` on the panels batch, the
    kernel phase's), the kernel phase's K2 and K3 at part 0 of the unsplit
    mesh cut at 40 x 8 (``MESH_WORD_SHAPE``) and 48 x 4, and the card
    tests ``test_softmax_spmm_words_match_plain`` (``WORD_CASES``: an odd
    row count, a gap, empty rows, the same bits twice). A check that raises
    catches the fault; its message is reported. Then the source check of
    the copy's K3 (``returns_before_last_shuffle``)."""
    import importlib.util

    import torch

    import chip_smoke as cs

    # by its path: on the card's machine another package may own the name `tests`
    spec = importlib.util.spec_from_file_location("card_tests", os.path.join("tests", "test_torch_port_cuda.py"))
    cards = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cards)
    dev = torch.device("cuda")
    out = {"fault": name}

    def check(label, fn):
        cards._poison_free_memory(dev)
        try:
            fn()
            out[label] = "passed"
        except AssertionError as err:
            out[f"{label}_caught_by"] = str(err)[:300]

    batch = cs.panels_batch(200)
    check("k2_geometry_cases", lambda: cs.k2_f32_geometry_cases(batch, 83))
    check("k3_geometry_cases", lambda: cs.k3_f32_geometry_cases(batch, 83))
    part = cs.unsplit_part0(601)
    for label, width, heads, (k2_seed, k3_seed) in ((cs.MESH_WORD_SHAPE, 40, 8, (92, 93)),
                                                    ("mesh_16384_part0_of_4_unsplit_d48_h4", 48, 4, (87, 91))):
        check(f"k2_{label}", lambda: cs.k2_case(label, part, width, k2_seed, heads=heads))
        check(f"k3_{label}", lambda: cs.k3_case(label, part, width, k3_seed, heads=heads))
    for width, heads, aligned in cards.WORD_CASES:
        check(f"card_test_{width}x{heads}_{aligned}B",
              lambda: cards.test_softmax_spmm_words_match_plain(dev, width, heads, aligned))
    with open(K3) as f:  # the copy's source, as tests/test_torch_port_softmax_words.py reads the repo's
        early = returns_before_last_shuffle(f.read())
    out["source_check"] = f"caught: {early}" if early else "passed"
    return out


def read_width_fault(name: str) -> dict:
    """The word geometry's checks: the ``kernel_width`` cases
    (``fused_case`` at ``GENERAL_WIDTHS`` in both views on the panels
    batch) with ``SOFTMAX_RTOL``/``ATOL`` and ``K3_GRAD_RTOL``/``ATOL``
    lifted, each case's geometry and its forward's and backward's error
    against the plain versions, whether the limits catch it; then
    ``width_first_step`` (the panels transformer at hidden 48 in 4 heads,
    first step on the card against the CPU) with its limits lifted."""
    import chip_smoke as cs

    out = {"fault": name}
    limits = (cs.SOFTMAX_RTOL, cs.SOFTMAX_ATOL, cs.K3_GRAD_RTOL, cs.K3_GRAD_ATOL)
    # 1e30, not inf: inf * 0 is NaN, and a plain zero would then fail
    cs.SOFTMAX_RTOL = cs.SOFTMAX_ATOL = cs.K3_GRAD_RTOL = cs.K3_GRAD_ATOL = 1e30
    batch = cs.panels_batch(200)
    cases = [(w, v) for w in cs.GENERAL_WIDTHS for v in ("model", "contiguous")]
    for i, ((d, h), view) in enumerate(cases):  # chip_smoke.py's kernel_width seeds
        label = f"d{d}_h{h}_{view}"
        f, b = cs.fused_case(label, batch, d, 15 + i, library=False, heads=h, view=view, replaced=False)
        out[f"kernel_width_{label}"] = {
            "geometry": f["geometry"], "fwd_max_abs_err": f["out_ml_max_abs_err"],
            "bwd_max_abs_err": b["dq_dk_dv_max_abs_err"],
            "caught": max(f["out_ml_max_abs_err"]) > limits[1] + limits[0]
            or max(b["dq_dk_dv_max_abs_err"]) > limits[3] + limits[2]}
    cs.SOFTMAX_RTOL, cs.SOFTMAX_ATOL, cs.K3_GRAD_RTOL, cs.K3_GRAD_ATOL = limits
    cs.STEP_LOSS_RTOL = cs.STEP_ROUNDOFF_SHARE = math.inf
    param = cs.load_config(cs.PANELS_CONFIG)
    param["model"]["hidden_size"] = 48
    total_steps = 1 + cs.WARMUP_STEPS + cs.TIMED_STEPS + cs.PROFILED_STEPS
    step = cs.first_step(name, param, batch, 0, total_steps, math.inf)
    out["width_first_step"] = {**step, "caught": step["first_step_grad_rel_err_worst"] > cs.TRANSFORMER_GRAD_RTOL}
    return out


def read_bf16_words_fault(name: str) -> dict:
    """The bf16 word geometry's checks: the bf16 kernel phase's word cases
    (``fused_bf16_case`` at ``BF16_WORD_CASES`` on the panels batch, SDPA
    left out) at their limits (``BF16_KERNEL_RTOL``/``ATOL``,
    ``BF16_MISMATCH_SHARE``, the backward's bits twice): a case is caught
    where its check raises, whose message carries the errors and shares;
    a case not caught gives its errors and shares. Then
    ``bf16_width_training``'s first step (the panels transformer at hidden
    48 in 4 heads in bf16, on the card against the CPU on one 2,048-node
    graph) with its limits lifted."""
    import chip_smoke as cs

    out = {"fault": name}
    batch = cs.panels_batch(200)
    for i, (d, h, view) in enumerate(cs.BF16_WORD_CASES):  # chip_smoke.py's fused_bf16_kernels seeds
        label = f"d{d}_h{h}_{view}"
        try:
            f, b = cs.fused_bf16_case(label, batch, d, 44 + i, heads=h, view=view, library=False)
        except AssertionError as err:
            out[f"kernel_{label}"] = {"caught": True, "check": str(err)}
            continue
        out[f"kernel_{label}"] = {
            "caught": False, "geometry": f["geometry"], "fwd_max_abs_err": f["out_ml_max_abs_err"],
            "bwd_max_abs_err": b["dq_dk_dv_max_abs_err"],
            "mismatch_shares": [f["out_mismatch_share"], *b["dq_dk_dv_mismatch_share"]]}
    cs.STEP_LOSS_RTOL = cs.STEP_ROUNDOFF_SHARE = math.inf
    param = cs.with_precision(cs.load_config(cs.PANELS_CONFIG), "bf16", hidden_size=48)
    check = cs.random_csr_graph(cs.BATCH_NODES[1], cs.BATCH_EDGES[1], 2048, 12288, 51)
    total_steps = 1 + cs.WARMUP_STEPS + cs.TIMED_STEPS + cs.PROFILED_STEPS
    step = cs.first_step(name, param, check, 0, total_steps, math.inf, loss_rtol=math.inf,
                         roundoff_share=math.inf)
    out["bf16_width_first_step"] = {
        **step, "caught": step["first_step_grad_rel_err_worst"] > cs.BF16_GRAD_RTOL
        or step["first_step_loss_rel_err"] > cs.BF16_STEP_LOSS_RTOL
        or step["first_step_roundoff_share"] > cs.BF16_ROUNDOFF_SHARE}
    return out


def read_stream_fault(name: str) -> dict:
    """The ``stream_dtypes`` phase's checks with their limits lifted: the
    hub row and the 16-bit K1 against its plain version in ulps at the
    cylinder batch, both dtypes; the fused bf16 stream entry against its
    plain version and against the bf16 entry at the panels batch (the
    "differs" check stays, and a fault it catches is reported by its
    message)."""
    import torch

    import chip_smoke as cs
    import chip_stream as st

    out = {"fault": name}
    if name.startswith("stream_k2"):
        from graphphysics_torch.ops import csr_attention as ca

        graph = cs.panels_batch(200)
        seg, bounds, mask = (torch.as_tensor(a).to("cuda") for a in (graph.senders, graph.sender_bounds,
                                                                     graph.edge_mask))
        gen = torch.Generator(device="cuda").manual_seed(11)
        scores = torch.where(mask[:, None], 3 * torch.randn((seg.shape[0], cs.HEADS), generator=gen, device="cuda"),
                             torch.full((), ca.NEG, device="cuda"))
        values = torch.randn((seg.shape[0], cs.HIDDEN), generator=gen, device="cuda")
        with torch.no_grad():
            got, got_ml = ca.csr_softmax_spmm(scores, values, seg, bounds, mask, stream_dtype="bf16")
            want, want_ml = ca.csr_softmax_spmm_reference(ca.stream_round(scores), ca.stream_round(values), seg,
                                                          bounds.shape[1], mask)
        tol = {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}
        out.update({"shape": "panels_csr_batch_8x2048", "plain_max_abs_err": (got - want).abs().max().item(),
                    "plain_ml_max_abs_err": (got_ml - want_ml).abs().max().item(),
                    "plain_share_outside_tolerance": (~torch.isclose(got, want, **tol)).float().mean().item(),
                    "plain_within_tolerance": torch.allclose(got, want, **tol)
                    and torch.allclose(got_ml, want_ml, **tol)})
        try:
            st.k2_geometry_cases(graph, 50)
            out["geometry_cases"] = "passed"
        except AssertionError as err:
            out["geometry_cases_caught_by"] = str(err)[:300]
        return out
    if name.startswith("stream_k5"):
        from chip_partition import k5_inputs, mesh_graph
        from graphphysics_torch.ops import csr_attention as ca

        n, _, seg, masks, bounds, scores, values, _ = k5_inputs(mesh_graph("csr", 601), cs.HIDDEN, 84)
        args = (scores[0], values[0], seg[0], bounds[0], scores[1], values[1], seg[1], bounds[1], *masks)
        with torch.no_grad():
            got, got_ml = ca.csr_softmax_spmm_pair(*args, stream_dtype="bf16")
            rounded = [ca.stream_round(t) for t in (scores[0], values[0], scores[1], values[1])]
            want, want_ml = ca.csr_softmax_spmm_pair_reference(rounded[0], rounded[1], seg[0], rounded[2],
                                                               rounded[3], seg[1], n, *masks)
        tol = {"rtol": cs.SOFTMAX_RTOL, "atol": cs.SOFTMAX_ATOL}
        out.update({"shape": "mesh_16384_part0_of_4", "plain_max_abs_err": (got - want).abs().max().item(),
                    "plain_ml_max_abs_err": (got_ml - want_ml).abs().max().item(),
                    "plain_share_outside_tolerance": (~torch.isclose(got, want, **tol)).float().mean().item(),
                    "plain_within_tolerance": torch.allclose(got, want, **tol)
                    and torch.allclose(got_ml, want_ml, **tol)})
        return out
    if name.startswith("stream_k1"):
        st.K1_ULPS = math.inf
        for dt in (torch.bfloat16, torch.float16):
            key = st.SHORT[dt]
            try:
                out[f"hub_row_{key}"] = st.hub_row(dt)["hub_row"]
            except AssertionError as err:
                out[f"hub_row_{key}_caught_by"] = str(err)[:300]
            out[f"max_ulps_{key}"] = st.k1_16bit_case("flagship_batch_8x2048", cs.flagship_batch(0), dt,
                                                      0)[0]["max_ulps"]
        return out
    from graphphysics_torch.ops import csr_attention as ca

    seg, gather, bounds, mask, q, k, v, scale = st.fused_stream_inputs(cs.panels_batch(200), cs.HIDDEN, 17,
                                                                       torch.bfloat16)
    with torch.no_grad():
        got, _ = ca.csr_attention(q, k, v, seg, gather, bounds, mask, scale, stream_dtype="bf16")
        want, _ = ca.csr_attention_reference(q, k, v, seg, gather, bounds.shape[1], mask, scale,
                                             stream_dtype="bf16")
        base, _ = ca.csr_attention(q, k, v, seg, gather, bounds, mask, scale)
    out.update({"plain_max_abs_err": (got.float() - want.float()).abs().max().item(),
                "plain_mismatch_share": (got != want).float().mean().item(),
                "plain_within_tolerance": torch.allclose(got.float(), want.float(), rtol=cs.BF16_KERNEL_RTOL,
                                                         atol=cs.BF16_KERNEL_ATOL)})
    try:
        out.update(st._differs(name, got, base, rtol=cs.BF16_KERNEL_RTOL, atol=cs.BF16_KERNEL_ATOL))
    except AssertionError as err:
        out["differs_check_caught_by"] = str(err)[:300]
    return out


def read_fault(model: str, name: str) -> dict:
    """The fault's check with lifted limits, in the tree of the working
    directory."""
    import torch

    import chip_smoke as cs
    from graphphysics_torch.ops import _native
    from graphphysics_torch.ops import csr_attention as ca

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if model == "softmaxwords":  # its checks launch K2's f32 entry and K3 only
        _native.build((ca.SOURCE, ca.BACKWARD_SOURCE))
        return read_softmax_words_fault(name)
    _native.build()
    if name.startswith("resume"):
        return read_resume_fault(model, name)
    if model.startswith("accum"):
        return read_accum_fault(model, name)
    if model == "ell":
        return read_ell_fault(name)
    if model == "stream":
        return read_stream_fault(name)
    if model == "k1f32":
        return read_k1f32_fault(name)
    if model == "k2f32":
        return read_k2f32_fault(name)
    if model == "general":
        return read_general_fault(name)
    if model == "width":
        return read_width_fault(name)
    if model == "bf16words":
        return read_bf16_words_fault(name)
    cs.STEP_LOSS_RTOL = cs.STEP_ROUNDOFF_SHARE = math.inf
    total_steps = 1 + cs.WARMUP_STEPS + cs.TIMED_STEPS + cs.PROFILED_STEPS
    if model.startswith("bf16transformer"):
        param = cs.with_precision(cs.load_config(cs.PANELS_CONFIG), "bf16")
        batch = cs.random_csr_graph(cs.BATCH_NODES[1], cs.BATCH_EDGES[1], 2048, 12288, 51)
        step = cs.first_step(name, param, batch, 0, total_steps, math.inf, loss_rtol=math.inf,
                             roundoff_share=math.inf)
        if not model.endswith("+kernel"):
            return {"fault": name, **step}
        # and the bf16 kernel phase's check on the panels batch (not for a
        # fault that reads past a row: the phase's timed copies would read
        # past their allocation)
        cs.BF16_KERNEL_RTOL = cs.BF16_KERNEL_ATOL = cs.SOFTMAX_RTOL = cs.SOFTMAX_ATOL = 1e30
        cs.BF16_MISMATCH_SHARE = math.inf
        fwd, bwd = cs.fused_bf16_case("panels_csr_batch_8x2048", cs.panels_batch(200), cs.HIDDEN, 41)
        kernel = {"kernel_out_mismatch_share": fwd["out_mismatch_share"],
                  "kernel_dq_dk_dv_mismatch_share": bwd["dq_dk_dv_mismatch_share"],
                  "kernel_out_ml_max_abs_err": fwd["out_ml_max_abs_err"],
                  "kernel_dq_dk_dv_max_abs_err": bwd["dq_dk_dv_max_abs_err"]}
        return {"fault": name, **step, **kernel}
    if model == "epd":
        param, batch = cs.load_config(cs.CYLINDER_CONFIG), cs.flagship_batch(0)
    else:
        param, batch = cs.load_config(cs.PANELS_CONFIG), cs.panels_batch(200)
    return {"fault": name, **cs.first_step(name, param, batch, 0, total_steps, math.inf)}


def main() -> int:
    if len(sys.argv) == 3:  # the child: one fault, in its copy
        print("RESULT " + json.dumps(read_fault(*sys.argv[1:])), flush=True)
        return 0
    prefix = sys.argv[1] if len(sys.argv) == 2 else ""
    failed = 0
    for name, (model, source, line, faulty) in FAULTS.items():
        if not name.startswith(prefix):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            copy = os.path.join(tmp, "tree")
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(".git", "build", "chiprun_out"))
            path = os.path.join(copy, source)
            with open(path) as fp:
                text = fp.read()
            lines, faulties = ((line, faulty) if isinstance(line, tuple) else ((line,), (faulty,)))
            for old, new in zip(lines, faulties):
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: the line to replace is not in {source} once")
                text = text.replace(old, new)
            with open(path, "w") as fp:
                fp.write(text)
            script = os.path.join(copy, os.path.basename(__file__))
            proc = subprocess.run([sys.executable, script, model, name], cwd=copy,
                                  capture_output=True, text=True, timeout=600)
        lines = [x[len("RESULT "):] for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
        if proc.returncode or not lines:
            failed += 1
            print(f"{name}: failed\n{proc.stderr[-3000:]}", file=sys.stderr, flush=True)
        else:
            print(lines[-1], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

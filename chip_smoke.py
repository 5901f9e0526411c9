#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--frames 50] [--aneurysm-grid 32]

Run from the root of the repository on a machine with an NVIDIA Hopper card
and the CUDA toolkit. Phases, each of which raises on failure:

1. environment and build: the card (``nvidia-smi``), torch and CUDA
   versions, and ``nvcc`` building every kernel of ``graphphysics_torch/csrc``
   at once (one process per source), with each source's build seconds,
   ``g++`` building the host C++ of ``graphphysics_torch/native`` beside
   them (``host_build_s``);
2. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, with device times, the memory bound and, where one exists, one
   PyTorch call as a yardstick. K1 (``csr_segment_sum``) at the EPD serving
   frame, the cylinder training batch (8 graphs of 2,048 nodes / 12,288
   edges) and the aneurysm_epd scale (66,560 nodes / 524,288 edges); K2
   (``csr_softmax_spmm``) at the transformer serving frame, the panels_csr
   batch (8 x 2,048 / 12,288) and the aneurysm_csr scale (66,560 / 524,288,
   width 64); the fused attention forward (``csr_attention``) and backward
   (``csr_attention_backward``) at K2's shapes, q, k and v in the model's
   layout, each beside its plain version, the PyTorch path it replaced
   (gathers + SDDMM around K2; autograd through them with K3) and SDPA with
   the dense adjacency as its mask (frame and batch), at every lane count
   the width allows. K1's records name the lane geometry that ran and a
   digest of the output (K1 bit-equal on a second run); then the f32 K1 in
   each geometry (widths 128, 64, 48, 130 on data 16- and 4-byte aligned:
   within ``KERNEL_ATOL`` of plain, the same bits twice and across
   geometries) and a hub row of 4,096 unit edges reading exactly 4,096 in
   both; K2 and K3 also at part 0 of the unsplit 4-way cut of the
   16,384-node mesh, the shape their own path runs, and at the widths JAX
   takes that only the general geometry opened to them (``GENERAL_WIDTHS``
   at the batch, 48 x 4 and 40 x 8 at the mesh part; 40 x 8 there,
   ``MESH_WORD_SHAPE``, is the shape the word geometry runs on its path and
   the one its kernels-line entries report) and at 160 in 5 heads, past 32
   words (the batch, and ``MESH_GENERAL_SHAPE`` at the mesh part: the
   general geometry's entries). K2's records name the
   geometry that ran (``softmax_spmm_geometry``, and a general one's
   columns, ``softmax_spmm_columns``; ``kind``, ``softmax_spmm_kind``), a digest of the output
   (bit-equal on a second run), the launch floor and the share of the
   bound; then the f32 K2 and K3 in each geometry
   (``K2_F32_GEOMETRY_CASES`` on the panels batch, views 16- and 4-byte
   aligned: within ``SOFTMAX_RTOL``/``ATOL`` or ``K3_RTOL``/``ATOL`` of
   plain, the same bits twice, empty rows and masked edges exact; the
   f32 K2's cases timed, so the V columns at 256 x 4, 512 x 8 and 32 x 16
   stand beside the general geometry on 4-byte views of the same widths);
3. EPD serving: a synthetic cylinder trajectory rolled out by the 15 x 128
   EncodeProcessDecode simulator (random weights from the seed) on the card,
   checked against the same rollout on the CPU, with the launch counts
   (and, here and in ``epd_training``, the f32 K1's launches by geometry:
   all 16-byte words);
4. EPD batched forward: one eval forward on the cylinder batch;
5. transformer serving: a synthetic panels trajectory rolled out by the
   15 x 128, 4-head EncodeTransformDecode simulator built from
   ``training_config/panels.json`` (random weights from the seed), checked
   the same way;
6. transformer batched forward: one eval forward on the panels_csr batch;
7. backward kernels: K1b (``csr_segment_sum_backward``) at K1's three shapes
   and K3 (``csr_softmax_spmm_backward``) at K2's (K2 and K3 run on no
   path of the models now: the fused kernels took their place), each against its plain
   version on the card, ``torch.autograd.grad`` through the wrapper against
   the same call through the plain forward, with device times and bounds;
8. training: ``Trainer`` steps of the 15 x 128 EncodeProcessDecode
   (``training_config/cylinder.json``) on the cylinder batch and of the
   15 x 128, 4-head EncodeTransformDecode (``panels.json``) on the panels_csr
   batch: 3 warm-up steps, 12 timed ones with the launches per step checked,
   the first step against the same step on the CPU from equal weights, and
   a ``torch.profiler`` breakdown of 3 steps;
9. training pipeline: synthetic trajectories through ``BaseDataset``,
   ``GraphLoader`` and ``Trainer.fit`` with rollout validation, for both
   models, launches checked;
10. checkpoints (``epd_checkpoint``, ``transformer_checkpoint``): on the
    same kind of in-memory trajectories, per model, ``fit`` for 2 epochs
    saving every step (run A), the same interrupted after batch 2 (run B)
    and resumed from its checkpoint (run C), held against A (step,
    learning rate and batch stream exactly, parameters within
    ``RESUME_MEDIAN_RTOL`` and a per-model worst limit); the final checkpoint reloaded into a fresh
    ``Trainer`` on the card bitwise; ``predict`` from it on the card with
    its launches checked, against the trained model's and the CPU's; the
    checkpoint's bytes, save and load seconds and predict's ms per frame;
11. fused attention widths: both fused kernels against their plain versions
    at (D, H) = (48, 4), (96, 3) and (40, 8), in the model's (N, Dh, H) view
    (beside SDPA) and in contiguous [N, H, Dh], on the panels_csr batch (the
    word geometry of ``csrc/attention_words.cuh`` in the model's view and
    at 96 x 3 contiguous: a word of columns a lane, per-head partials
    reduced by shuffles, one head's softmax a lane; the fast geometry at
    48 x 4 and 40 x 8 contiguous), timed at each lane count (the general
    geometry of ``csrc/csr_attention.cuh`` at the others, and at
   ``F32_GENERAL_CASE``, 160 x 4, past the word geometry's 32 lanes); the first
    train step of the panels transformer at ``hidden_size`` 48 against
    the CPU
    (``width_first_step``); then that transformer trained (3 warm-up and
    12 timed steps, its 15 + 15 fused launches a step all counted in the
    word geometry, the fused kernels' device ms from a profile) and an
    eager eval forward on the serving frame, beside the 128 x 4 step
    (``width_training``; shared-card times, the multi-rank phases run
    beside it);
12. ``gmm_training``: ``Trainer`` on ``training_config/c-a-gmm.json``
    (EncodeTransformDecode 10 x 64, 4 heads, K = 3 diagonal GMM head) on one
    sender-sorted aneurysm-scale graph (66,000 real nodes and 520,000 real
    edges padded to 66,560 / 524,288, 14 features and the node type): the
    first step against the CPU (also with the full-covariance head), 3
    warm-up and 12 timed steps with 10 fused forward and 10 fused backward
    launches per step checked, and a profile;
13. ``gmm_serving``: a 50-frame sampled rollout of that model on a synthetic
    14-feature trajectory at that scale, with its launches checked; two card
    rollouts of one generator seed bitwise equal; the first 3 frames on the
    card against the CPU's with the draws of one CPU generator; the card
    sampler's statistics over 2^20 draws of a fixed mixture;
14. ``gmm_pipeline``: ``panels.json`` with a K = 3 head through
    ``BaseDataset``, ``GraphLoader``, ``Trainer.fit`` with validation
    (``val_loss`` None), a save, a reload and ``predict`` twice, bitwise
    equal;
15. ``aneurysm_xdmf_pipeline``, once per config, for
    ``training_config/coarse-aneurysm.json`` and ``c-a-gmm.json`` at their
    full width and depth: synthetic aneurysm trajectories on
    ``tet_grid(32)`` (32,768 nodes, 178,746 tetrahedra, 434,558 directed
    edges; ``--aneurysm-grid 40``: 64,000 nodes, 858,078 edges; 2 training
    and 1 held-out of 6 frames) written as XDMF with the
    heavy data inline (``chip_fidelity.write_aneurysm_inline``), read by
    ``get_dataset`` (``XDMFDataset``, previous-frame data, the aneurysm
    features of ``external.build_features``, sender-sorted graphs): the
    XDMF read and the preprocessing timed apart; ``Trainer.fit`` for one
    epoch with rollout validation; the first train step against the CPU
    (from the epoch's normalizer statistics), 3 warm-up and 12 timed steps
    with 10 fused forward and 10 fused backward launches per step, a
    profile; a reload and ``predict`` over the held-out trajectory
    (launches checked); its first 3 frames with the
    previous-data slice fed back against the CPU (the GMM head under shared
    CPU draws);
16. ``plate_pipeline``: ``training_config/plate.json`` as published
    (EncodeTransformDecode 10 x 64, 4 heads, no edge inputs; world edges at
    the default radius 0.03; noise 0.003 on columns 0:3) on synthetic press
    trajectories held in memory (``synthetic.plate_press_trajectory`` on
    ``tet_box(48, 48, 8)`` and the punch: 18,450 nodes, about 234,000
    directed edges; 2 training trajectories and 1 held-out one of 12
    frames, one frame a batch, sender-sorted graphs): the host's
    milliseconds per sample (the load, the world edges, the rest of the
    preprocessing, the padding) and the world edges of each frame (more
    than 0 once the punch touches); ``Trainer.fit`` for one epoch with
    rollout validation twice, its loader building the items in-process and
    then in ``PLATE_WORKERS`` worker processes (prefetch 2), the two
    epochs' batches bit-equal, each fit's wall time and the card's idle
    share (the device time traced over the first); the started workers'
    items per second over a second epoch against the host's one sample at
    a time; ``train`` on the epoch's first batch (the first step against
    the CPU from the fit's normalizer statistics, 10 fused forward and 10
    fused backward launches per step); ``predict`` over the held-out
    trajectory from the reloaded checkpoint, and its first 3 frames against
    the CPU;
17. ``cylinder_fidelity_short``, ``panels_fidelity_short``,
    ``plate_fidelity_short`` and ``aneurysm_fidelity_short``: 2 epochs of
    ``chip_fidelity.run`` for each config (the fidelity runs at full width
    and depth on their own data): the training loss and the held-out
    rollout RMSE fall;
18. ``fused_bf16_kernels``: the fused attention's bf16 kernels
    (``csr_attention_bf16.cu``, ``csr_attention_bwd_bf16.cu``: 16-byte
    lanes, a backward by sender rows and then by gather rows over the
    graph's transposed CSR, ``gather_csr``) against their plain versions on
    the same bf16 inputs (within two bf16 ulps, and at most
    ``BF16_MISMATCH_SHARE`` of the elements differing at all), the backward
    bit-equal on a second call, at the serving frame, the panels batch and
    the aneurysm scale (widths 128, 128, 64 in the model's (N, Dh, H) view)
    and on the panels batch at width 64; then the word geometry of
    ``csr_attention_bf16_words.cu`` (one word of 8 or 4 bf16 columns a
    lane, per-head partials reduced by shuffles, one head's softmax a lane;
    the same two backward parts) at ``BF16_WORD_CASES`` on the panels
    batch: 48 x 4, 96 x 3 and 40 x 8 in the model's view, 96 x 3 and 48 x 4
    contiguous, 20 x 4, 36 x 4 and 20 x 1 (8-byte words) and 48 x 4 on rows
    only 8-byte aligned; the general geometry at 160 x 4 on rows only
    8-byte aligned (``BF16_GENERAL_CASE``: words past 32 lanes); each timed
    beside its bound (2 bytes a q, k, v, out, g, dq, dk and dv element), its
    plain version, the f32 entry on the same shapes and SDPA in bf16 (frame,
    batch, d64, and once at 48 x 4, 96 x 3 and 40 x 8:
    ``BF16_WORD_LIBRARY``), the transposition timed on its own
    (``transpose_ms``); and the bf16 stream twin at 48 x 4
    (``chip_stream.fused_stream_case``, q and k on a 1/16 grid);
19. ``bf16_epd_training``, ``bf16_transformer_training``,
    ``bf16_gmm_training``: ``train`` of ``cylinder.json``, ``panels.json``
    (8 x 2,048 batches) and ``c-a-gmm.json`` (the 66,560-node graph) with
    ``"precision": "bf16"``: 12 timed steps with the launches checked (the
    EPD's K1 and K1b f32 entries; the transformers' bf16 attention kernels
    and one transposed CSR a step), the first step against the CPU in bf16
    on one 2,048-node graph, a profile, each beside the f32 phase's
    readings; for the panels transformer, whether two bf16 steps (and two
    f32 steps) from one seeded state give the same bits (reported, not
    checked);
20. ``bf16_serving``: 50-frame rollouts of both 15 x 128 families in bf16,
    3 frames against the CPU, eager and CUDA-graph forwards;
21. ``remat_training``: the panels transformer and the cylinder EPD with
    ``"remat": true``: the first step's gradients against the plain blocks'
    on the card, twice the forward launches, 5 timed steps and peak memory
    each;
22. ``large_mesh_training``: ``benchmarks/large_mesh_training.py``'s run
    (the transformer 10 x 64, degree 8, a learnable target) with lever
    ``bf16`` and ``none`` at 229,376 nodes and ``remat`` at 524,288: 3
    warm-up and 10 timed steps, launches, peak memory, device time, the
    loss falling; and lever ``microbatch``: 4 microbatches of the f32
    229,376-node graph (one topology, 4 seeded feature and target sets) a
    gradient-accumulation step, its peak memory within
    ``LARGE_MESH_MICRO_PEAK`` of the one-graph f32 step's;
23. ``grad_accum_epd`` and ``grad_accum_transformer``: ``cylinder.json``
    and ``panels.json`` (15 x 128) on their training batches' 8 graphs as
    the M = 8 microbatches of one ``Trainer(gradient_accumulation=True)``
    step against the concat step from equal weights (loss, each
    parameter's gradient, the normalizer counters at exactly 1),
    ``ACCUM_TIMED_STEPS`` timed steps of each with the launches checked
    (one forward and one backward launch a block and microbatch), peak
    memory under
    ``ACCUM_PEAK_SHARE`` of the concat step's;
24. ``ell_pipeline``: ``cylinder.json`` and ``panels.json`` with
    ``"edge_layout": "ell"`` on the synthetic 2,048-node trajectories:
    ``Trainer.fit`` for one epoch with validation, a reload and
    ``predict`` over 3 frames against the CPU, no kernel launched (the
    count asserted), the first ELL step against the CPU and against the
    model's own layout on the same frames, ``ELL_TIMED_STEPS`` timed
    steps of both layouts;
25. ``bucketed_pipeline``: the cylinder EPD on trajectories of three mesh
    sizes (512, 1,536 and 2,048 nodes; the smallest with fewer items than
    a batch) in 2 size buckets, batches of 4: a one-epoch fit with
    validation in-process, with 2 loader workers (batches bit-equal) and
    with one bucket; every batch padded to a bucket budget, the small
    bucket's batch filled with a masked copy, which changes nothing in a
    step on the card;
26. ``project_before_gather``: one 128-wide ``GraphNetBlock`` with the
    knob against the plain block on the flagship batch, forward and
    backward, each timed;
27-31. edge partitioning (``chip_partition.py``): ``k5_pair`` (K5 forward
    and backward against their plain versions at three parts of a 4-way
    split, and at the split path's 40 x 8 shape, K5's general geometry),
    ``partitioned_epd_training`` and
    ``partitioned_transformer_training`` (4 ranks sharing the card over
    gloo, the first step against the unpartitioned card step, 3 timed
    steps with the launches checked; the transformer also at hidden 48 in
    4 heads, 40 in 8 and 160 in 5, split-edge and unsplit, 2 counted steps
    each, the unsplit K2 and K3 launches counted by geometry, each first
    step against the unpartitioned card step at its width and the unsplit
    first step against the split-edge one), ``partitioned_rollout`` (10 frames
    of each family against the unpartitioned card rollout) and
    ``partitioned_fit`` (``grph-torch train|predict --graph_partition 4``);
32-37. the serving artifacts, the directory checkpoints and the utilities
    (``chip_utilities.py``; every kernel is a ``torch.library`` op, which
    ``torch.export`` traces): ``export_serving`` (the 15 x 128 EPD, the
    panels transformer and that transformer in bf16, their eval steps
    exported, saved, loaded and run on the card, 15 launches of K1, the
    fused f32 or the fused bf16 kernel a frame, within 1e-6 of the live
    step, ms per frame exported and eager; a 2-frame exported EPD rollout
    against the live one), ``checkpoint_backends`` (``orbax`` and
    ``orbax-async`` directories reloaded bit for bit, a resumed step),
    ``profiler`` (3 ``fit`` steps traced with ``profile_dir``, the trace
    naming K1, K1b and the fused pair), ``determinism`` (on the trainers
    of the two phases before it; only the bf16 transformer step must
    replay bit for bit), ``compilation_cache`` and ``doctor``
    (``grph-torch doctor`` returns 0 in this process; its probes);
38-41. data parallelism (``chip_parallel.py``): ``dp_epd_training`` and
    ``dp_transformer_training`` (the 8 x 2,048 batches stacked, 2 ranks of
    ``Trainer(data_parallel=True)`` sharing the card over gloo, 4 graphs a
    rank, the first step against the single-process step, 3 timed steps
    with the launches checked), ``dp_2d_training`` (4 ranks, 2 data rows of
    2 parts: the EPD in halo mode, the aneurysm transformer split-edge,
    each first step against the 1-D data-parallel step on the
    unpartitioned graphs) and ``dp_validation`` (``parallel_validation``
    against the sequential validation on 2 ranks); the 2-D layout is made
    by ``make_hybrid_layout`` (data across two emulated hosts, the graph
    axis inside one) and its rank grid printed;
42-47. tensor and pipeline parallelism and the partitioned serving export
    (``chip_model_parallel.py``): ``tp_epd_training`` and
    ``tp_transformer_training`` (2 ranks of the model axis on the 8 x
    2,048 batches; the transformer's ranks hold 2 heads, 64 wide),
    ``pp_epd_training`` and ``pp_transformer_training`` (3 stages, the
    batches' 8 graphs as microbatches), ``pp_gmm_training`` (``c-a-gmm``
    on 2 stages, 4 microbatches of 16,640 nodes), each first step against
    the single-process step, timed steps with the launches checked; and
    ``export_partitioned_serving`` (the EPD's partitioned eval step on a
    16,384-node mesh exported, saved, loaded on 2 ranks, 10 frames, against
    the live partitioned forward and the unpartitioned eval); the kernel
    widths of phase 11 gain the tensor-parallel ranks' local widths,
    (D, H) = (64, 2) and (32, 1), f32 and bf16.
48. ``host_native`` (right after the build): the host C++ graph builders
    that the data path's ``face_to_edge``, ``k_hop_edges`` and
    ``build_ell`` run, each against its plain numpy / scipy version on the
    host CPU (FaceToEdge on ``tet_grid(32)``'s faces, k-hop at k = 2 and 3
    on the 16,384-node grid, the ELL grouping of 8 cylinder meshes as one
    graph), best of 3, every output bit-equal;
49. ``partitioned_no_exchange`` (in ``chip_partition.py``'s 4-rank spawn):
    the partitioned EPD step with the f32 wire, 1 warm-up and 5 timed
    steps under ``ops.halo.stub_exchange_for_benchmark`` (the halo
    exchange the identity) beside its timed steps without it: ms a step a
    rank with and without the exchange, its share, K1 and K1b counted;
50. ``stream_dtypes`` (``chip_stream.py``, after the K3 kernel phase): the
    TPU kernels' two 16-bit stream modes. K1 and K1b on bf16 and f16 data
    at K1's shapes (the forward within one ulp of the output dtype of its
    plain version, the backward bit-equal, a hub row of 4,096 unit edges
    reading exactly 4,096 in each of the 16-bit K1's geometries); the
    ``stream_dtype="bf16"`` entries of K2, K5 and the fused forward (f32
    and bf16 q, k, v) at their kernels' shapes, each against its plain
    version and each differing from the mode without the stream by more
    than that tolerance; every geometry of the 16-bit K1 and of K2's and
    K5's streams (by width, heads and alignment) against its plain version,
    each entry's outputs bit-equal on a second run and K1's in every
    geometry of a width, with their geometry and a digest of each output;
    all timed beside their
    bounds, plain versions, the entries without the stream and (K1) the
    upcast path they replace and ``index_add_``. Then the slice's path:
    ``masked_segment_sum`` on bf16 and f16 data and the three functions
    with the stream, forward and backward, each new entry and each
    backward entry they take counted once, nothing else.

51. ``bf16_width_training``: ``panels.json`` at ``hidden_size`` 48 in 4
    heads with ``"precision": "bf16"`` (15 x 48, the bf16 word geometry's
    path) on the panels batch: its first step against the CPU in bf16 on
    one 2,048-node graph (``BF16_GRAD_RTOL``), 3 warm-up and 12 timed steps
    with 15 + 15 bf16 fused launches a step all counted in the word
    geometry (``csr_attention.bf16.geometries``, 0 general) and one
    ``gather_csr``, two steps replayed bit for bit (asserted), the fused
    kernels' device ms from a profile, an eager eval forward on the serving
    frame (15 word-geometry forwards), beside the bf16 128 x 4 step and the
    f32 ``width_training`` (shared-card times).
The kernels are timed first (the bf16 fused kernels and K5 right after the
others), alone on the card. Then a second process (``chip_parallel.
start_multirank``) runs phases 17, 27-31 and 38-47, every phase that starts
ranks, with launch counters of its own, beside the phases that run in this
one; its output and its phase lines are printed when it ends, before the
kernels line, so its ranks' times and the times of the phases beside them
are those of two processes sharing the card and the host.

The K1 phase also times a one-element PyTorch elementwise kernel under the
same CUDA-graph replay (``launch_floor_ms``): the floor under any kernel's
time there. Every line but the last is a JSON object (one per phase, with
the seconds since the line before it as ``phase_s``, in the process that
ran it), apart from the card's
``nvidia-smi`` line; the ``{"kernels": [...]}`` line comes just before
the last line, ``{"ok": true, "device": {...}}``. Exits non-zero, printing
no result, without a CUDA card or outside the repository. float32 matmuls run
without TF32 (``allow_tf32 = False`` for matmul and cuDNN): the CPU
comparison is float32; bf16 matmuls sum in f32
(``allow_bf16_reduced_precision_reduction = False``), as on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores (same sheet)
L2_BYTES = 50 * 2**20
HIDDEN = 128
BLOCKS = 15
HEADS = 4
# f32 sums of ~10 N(0,1) terms per row in another order than index_add_
KERNEL_ATOL = 1e-4
# the f32 K1's geometry checks: widths (16-byte words at one, two and
# four-idle-lane rows a warp; single columns) and data alignments
K1_F32_WIDTHS = (128, 64, 48, 130)
K1_F32_ALIGNMENTS = (16, 4)
# K1b is a gather: exact
GATHER_ATOL = 0.0
# K3 vs its plain version: the same formula, expf and per-head sums in
# another order
K3_RTOL, K3_ATOL = 1e-5, 1e-5
# K3 through autograd vs autograd of the plain two-pass softmax: the delta
# identity against the softmax's own backward, f32
K3_GRAD_RTOL, K3_GRAD_ATOL = 1e-4, 1e-4
# K2: online vs two-pass softmax in f32, a few ulps per edge of a row
SOFTMAX_ATOL = 1e-5
SOFTMAX_RTOL = 1e-5
# the f32 K2's and K3's geometry checks (width, heads, alignment of the
# values): K2's 16-byte words at one, two and four rows a warp (heads of
# 32, 16 and 4); D / 32 adjacent columns a lane (heads of 2; past 128 wide;
# K3's at every multiple of 32 whose heads are whole lanes); the widths JAX
# takes that needed the general geometry (heads of 4, 5, 12, 32 and 8: K2's
# 16-byte words where a head is 4k wide, else the 16-byte words that span
# heads; K3's words), and views only 4-byte aligned (strided columns for
# both); the words at heads of 9 and of 5 with D % 8 == 4; the general
# geometry on 8-byte views at 40 x 8 and 48 x 4 and a 4-byte view at 20 x 4
# (8- and 4-byte words ran slower there) and at 160 in 5 heads (40 words,
# past 32 lanes)
K2_F32_GEOMETRY_CASES = ((128, 4, 16), (128, 8, 16), (64, 4, 16), (32, 8, 16), (32, 16, 16), (256, 4, 16),
                         (512, 8, 16), (16, 4, 16), (40, 8, 16), (48, 4, 16), (96, 3, 16), (24, 3, 16),
                         (128, 4, 4), (48, 4, 4), (256, 4, 4), (512, 8, 4),
                         (36, 4, 16), (20, 4, 16), (40, 8, 8), (48, 4, 8), (20, 4, 4), (160, 5, 16))
# GPU vs CPU rollout, f32 without TF32, first frames
ROLLOUT_ATOL = 1e-4
ROLLOUT_RTOL = 1e-4
CPU_FRAMES = 3
PANELS_CONFIG = "training_config/panels.json"
CYLINDER_CONFIG = "training_config/cylinder.json"
GMM_CONFIG = "training_config/c-a-gmm.json"
# the aneurysm workload scale: real nodes and edges, and their padding
ANEURYSM = (66000, 520000, 66560, 524288)
# the aneurysm XDMF pipeline: both aneurysm configs on tet_grid(32) (32,768
# nodes, 178,746 tetrahedra, 434,558 directed edges), 2 training
# trajectories and 1 held-out one of 6 frames, their heavy data inline in
# the XML (the card's machine has no h5py); previous-frame data fed back
# into the acceleration columns 5:8 of the aneurysm features. At
# tet_grid(40) (64,000 nodes, 858,078 edges; --aneurysm-grid 40) each
# config's phase took 75-85 s on the card's host, over the ~60 s it is
# given, most of it reading the XML (0.83-0.91 s a sample) and building
# the edges (0.53-0.91 s a sample).
ANEURYSM_CONFIGS = ("training_config/coarse-aneurysm.json", "training_config/c-a-gmm.json")
ANEURYSM_GRID, ANEURYSM_FRAMES = 32, 6
ANEURYSM_TRAJECTORIES, ANEURYSM_HELD_OUT = 2, 1
ANEURYSM_PREVIOUS = {"use_previous_data": True, "previous_data_start": 5, "previous_data_end": 8}
HOST_SAMPLES = 2  # items timed apart: the XDMF read, then the preprocessing
# the plate pipeline: plate.json on 2 training and 1 held-out press
# trajectories of 12 frames on tet_box(48, 48, 8) and the punch (18,450
# nodes), held in memory (the card's machine has no h5py). Cut from 20
# frames, at which the phase took 92 s of the ~60 s it is given, most of
# it the host building samples (0.22-0.28 s each); at 8 frames the first
# step's check against the CPU read 1.9e-3 of a bias gradient (its
# normalizer statistics from 14 items): 12 stay.
PLATE_CONFIG = "training_config/plate.json"
PLATE_GRID, PLATE_FRAMES = (48, 8), 12
PLATE_TRAJECTORIES, PLATE_HELD_OUT = 2, 1
# the worker loader's processes: one core is the training thread's
PLATE_WORKERS = min(4, (os.cpu_count() or 2) - 1)  # the host also runs the ranks of the second process
FIDELITY_SHORT_EPOCHS = 2
FIDELITY_CONFIGS = ("cylinder", "panels", "plate", "aneurysm")
# the kernels each fidelity run's model launches
FIDELITY_KERNELS = {
    "cylinder": ("csr_segment_sum", "csr_segment_sum_backward"),
    "panels": ("csr_attention", "csr_attention_backward"),
    "plate": ("csr_attention", "csr_attention_backward"),
    "aneurysm": ("csr_attention", "csr_attention_backward"),
}
# (width, heads) of the fused kernels' general geometry phases
GENERAL_WIDTHS = ((48, 4), (96, 3), (40, 8))
# K2's and K3's word geometry on its path: part 0 of the unsplit 4-way mesh
# cut at hidden 40 in 8 heads (both in words spanning heads of 5), the
# kernels line's shape of csr_softmax_spmm_words and _backward_words (the
# general geometry's shape until the words took the width)
MESH_WORD_SHAPE = "mesh_16384_part0_of_4_unsplit_d40_h8"
# their general geometry on its path: the same part at hidden 160 in 5 heads
# (40 words of 4, past 32 lanes), the kernels line's shape of
# csr_softmax_spmm_general and _backward_general
MESH_GENERAL_SHAPE = "mesh_16384_part0_of_4_unsplit_d160_h5"
# a width of the fused f32 entries past their word geometry (160 columns in
# 16-byte words: 40 words, past 32 lanes), which keeps the general code of
# csr_attention.cuh: (D, H, view) on the panels batch
F32_GENERAL_CASE = (160, 4, "model")
# the shape the fused f32 word geometry runs on its path (width_training):
# the panels batch at hidden 48 in 4 heads, the model's view
WORD_SHAPE = "panels_csr_batch_8x2048_d48_h4_model"
# the fused bf16 entries' word geometry (csrc/csr_attention_bf16_words.cu):
# (D, H, view) on the panels batch: 16-byte words at 48 x 4, 96 x 3 and
# 40 x 8 in the model's view and at 96 x 3 and 48 x 4 contiguous, 8-byte
# words at 20 x 4, 36 x 4 and 20 x 1 (D % 8 == 4: the widths that caught a
# cut word) and at 48 x 4 on rows only 8-byte aligned; its path's shape
# (bf16_width_training) is BF16_WORD_SHAPE
BF16_WORD_CASES = ((48, 4, "model"), (96, 3, "model"), (40, 8, "model"), (96, 3, "contiguous"),
                   (48, 4, "contiguous"), (20, 4, "model"), (36, 4, "model"), (20, 1, "model"),
                   (48, 4, "model_8_byte"))
BF16_WORD_SHAPE = "panels_csr_batch_8x2048_d48_h4_model"
# the word cases whose SDPA is timed: PERF.md's rows of the bf16 general
# widths (the other cases check cut words and alignments, and each SDPA of a
# dense 16,384^2 mask costs seconds of the script)
BF16_WORD_LIBRARY = ((48, 4), (96, 3), (40, 8))
# a width the bf16 word geometry cannot hold, which keeps the general
# geometry of csr_attention.cuh (160 columns in 8-byte words: 40 words, past
# 32 lanes): (D, H, view) on the panels batch
BF16_GENERAL_CASE = (160, 4, "model_8_byte")
# the local widths of panels' 128 wide x 4 heads on 2 and 4 tensor-parallel ranks
TP_LOCAL_WIDTHS = ((64, 2), (32, 1))
# the card sampler's statistics: draws of a fixed mixture, and the most
# standard errors any frequency, mean or std may lie from the mixture's own
GMM_SAMPLER_DRAWS = 2**20
GMM_SIGMAS = 5.0
# the card-vs-CPU rollout under shared draws: a node whose two best
# (logit + Gumbel) scores on the CPU lie closer than the card's logits
# differ from the CPU's (f32 round-off) may pick another component on the
# card; seeds are tried in turn until every sampled node's gap is at least
# GMM_TIE_FACTOR times that difference in the checked frames
GMM_TIE_FACTOR = 4.0
GMM_SEED_TRIES = 12
# 12 timed steps, cut from 20 to keep the script inside its time limit
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 12, 3
# timed steps of the gradient-accumulation phases (each microbatch step
# about 5-8 training steps' time) and of the ELL phase's two layouts: fewer
# than TIMED_STEPS, to keep the script inside its time limit
ACCUM_TIMED_STEPS, ELL_TIMED_STEPS = 8, 8
# first training step on the card vs the CPU from equal weights: f32
# without TF32, 15 blocks deep, sums in another order and atomics in the
# gathers' (EPD) and the fused attention's (transformer) backward
STEP_LOSS_RTOL = 1e-5
# ||grad_card - grad_cpu|| / ||grad_cpu|| of each parameter, the worst one
# taken, per model: 15 blocks of f32 forward and backward in two summation
# orders. Sound runs on an H100 read 4.5e-4 (EPD) and 8.4e-7-1.1e-6
# (transformer); the same check on copies with a planted fault
# (chip_smoke_mutants.py) read 0.16 and 0.28 (K1b dropping one graph's
# gradient, or the last edge of each row) and 1.04e-3, 1.04e-2, 0.70 and
# 0.32 (the fused attention backward with ds 0.1% or 1% off, one graph's
# dk dropped, or each row's last edge dropped from dq).
EPD_GRAD_RTOL = 1e-2
TRANSFORMER_GRAD_RTOL = 1e-4
# parameters whose gradient is 0 in exact arithmetic: the softmax ignores a
# shift shared by a query's scores, so the key bias gets round-off only. Its
# largest gradient entry, over the largest of all other parameters', is held
# below STEP_ROUNDOFF_SHARE on each device instead (2.6e-10 read).
ROUNDOFF_LEAVES = ("k_proj.bias",)
STEP_ROUNDOFF_SHARE = 1e-6
# the resumed run (C) against the uninterrupted one (A) on the card, per
# parameter ||C - A|| / ||A - start||: the backwards sum with atomics
# (EPD: the gathers' index_add_; transformer: the fused attention's dk and
# dv), so two runs differ in round-off, which Adam's
# normalized steps carry into the weights. The median over the parameters
# and the worst one are held to limits. Sound runs on an H100 (C, and a
# rerun A' of A, two runs with the mutants' reruns) read medians of
# 8.9e-4-1.5e-3 (EPD) and 3.3e-6-4.3e-4 (transformer), worst 0.0099-0.044
# (EPD) and 6.0e-5-1.7e-3 (transformer); the same check with a fault
# planted in the restore (chip_smoke_mutants.py) read medians of 0.62 /
# 0.51 (AdamW state not restored) and 0.023 / 0.020 (normalizer statistics
# zeroed), worst 0.83 / 0.61 and 0.080 / 0.053 (EPD / transformer). The
# median's limit sits between the two for both faults; the worst one's
# limits, 5x and 12x the largest sound reading, catch only gross faults.
RESUME_MEDIAN_RTOL = 5e-3
EPD_RESUME_WORST_RTOL = 0.2
TRANSFORMER_RESUME_WORST_RTOL = 2e-2
# the most one AdamW step moves a leaf, in units of its learning rate
# (|m_hat / sqrt(v_hat)| <= 1.17 with beta1**2 < beta2, plus the decay): a
# round-off-only leaf of C and A can differ by twice the summed rates
ADAM_STEP_MAX = 1.2
# in-memory trajectories of the checkpoint phases: 32 items, 4 batches of 8
CKPT_TRAJECTORIES = 4
# graphs of the two training batches: nodes and real edges of each, padded
# to 2,048 / 12,288. Graph 0 has n_pad == n with padded edges on its real
# last node, graph 4 no padding at all; the others pad both.
BATCH_NODES = [2048, 2000, 1950, 1900, 2048, 1800, 1700, 1600]
BATCH_EDGES = [11906, 12000, 11500, 11000, 12288, 10500, 10000, 9500]
# in the panels batch graph 5 sends from its first 1,200 nodes only, so the
# softmax rows of its other 600 real nodes are empty
EMPTY_ROWS_GRAPH, EMPTY_ROWS_SENDERS = 5, 1200
# the fused attention's bf16 entries against their plain versions: both
# compute in f32 and round each output to bf16 once, so they differ where
# f32 sums in another order round to neighbouring bf16 values: one bf16 ulp
# (at most 2^-7 of the value). Where the backward's ds = attn * (vg - delta)
# cancels, and in dv's per-edge roundings, f32 round-off can reach a bf16
# ulp before the last rounding: two ulps (2^-6). Plus f32 round-off near
# zero; and in dv, whose edge terms are rounded to bf16 before the sum (as
# JAX's), one term that rounds the other way moves a sum by that term's
# ulp: at most 2^-8 of max |g| (BF16_DV_TERM), which shows on sums that
# cancel (an H100 read dv 1 ulp of a term apart where the f32 sums agreed
# to 4e-6).
BF16_KERNEL_RTOL, BF16_KERNEL_ATOL = 2.0 ** -6, 1e-4
BF16_DV_TERM = 2.0 ** -8
# the share of a bf16 output's elements that differ from the plain
# version's at all: a rounding that falls the other way is rare (f32
# round-off against a bf16 ulp), a fault that rounds more often (dk or dv
# summed in bf16) moves most elements
BF16_MISMATCH_SHARE = 1e-2
# the first bf16 train step on the card against the CPU in bf16, on one
# 2,048-node graph: both round at the same places, but a value that lands
# within f32 round-off of a bf16 rounding boundary rounds the other way on
# one device, and that ulp travels through every block after it (and flips
# ReLU inputs near zero). Sound runs on an H100 read a worst
# per-parameter gradient of 0.086-0.14 (EPD, transformer) and 0.036 (GMM),
# medians 0.0017-0.071; 0.033 / 0.013 worst with the models cut to 2
# blocks. Planted faults (chip_smoke_mutants.py): a bf16 row read
# at the f32 stride read 434-458 (loss 1.9e-3 apart, round-off share
# 0.10-0.11); dk and dv summed in bf16 read 0.079-0.117, inside the sound
# spread at any depth: the kernel phase's mismatch share catches that one
# (0.32-0.35 of dk's and dv's elements against a sound 1.8e-3 at most,
# BF16_MISMATCH_SHARE). Sound losses read 1.9e-6-3.4e-5 apart, the
# round-off-only key bias at 1.0e-5 of the largest gradient.
BF16_STEP_LOSS_RTOL = 2e-4
BF16_GRAD_RTOL = 0.5
BF16_ROUNDOFF_SHARE = 1e-3
# bf16 rollouts, card vs CPU, first frames (an H100 read 1.5e-4-5.1e-4)
BF16_ROLLOUT_RTOL, BF16_ROLLOUT_ATOL = 5e-3, 5e-3
# remat vs the plain blocks on the card, each parameter's gradient: the
# same arithmetic, summed by atomics in another order
REMAT_GRAD_RTOL = 1e-4
REMAT_FORWARDS = ("csr_segment_sum", "csr_attention")  # launched again in the backward
REMAT_STEPS = 5
# benchmarks/large_mesh_training.py's levers and sizes: (lever, nodes), degree 8
LARGE_MESH = (("bf16", 229376), ("none", 229376), ("microbatch", 229376), ("remat", 524288))
LARGE_MESH_DEGREE, LARGE_MESH_WARMUP, LARGE_MESH_STEPS, PROFILED_LARGE_MESH = 8, 3, 10, 2
# the large mesh's microbatch lever: LARGE_MESH_MICRO microbatches of the
# f32 graph a step; its peak memory within LARGE_MESH_MICRO_PEAK of the
# one-graph f32 step's (their concatenation would need about 4x)
LARGE_MESH_MICRO, LARGE_MESH_MICRO_PEAK = 4, 1.25
# gradient accumulation (grad_accum_*): the 8 graphs of a training batch as
# the microbatches of one step, against the concat step from equal weights
# (the loss and gradient limits of first_step). Its peak memory must stay
# under ACCUM_PEAK_SHARE of the concat step's: at or above it, more than
# one microbatch's activations are alive.
ACCUM_PEAK_SHARE = 0.5
# the ELL pipeline: the synthetic trajectories of memory_datasets, and a
# held-out one of PREDICT_FRAMES + 1 frames for predict
PREDICT_FRAMES = 3
# the bucketed pipeline: synthetic cylinder trajectories of three mesh sizes
# (nx, ny, training trajectories), BUCKET_FRAMES frames each, one held out
# of each size; 2 buckets, batches of 4. The 512-node size has fewer items
# (3) than one batch, so its bucket's batch is filled with a masked copy.
BUCKET_SIZES = ((32, 16, 1), (48, 32, 4), (64, 32, 4))
BUCKET_FRAMES, BUCKET_BATCH, BUCKET_WORKERS = 4, 4, 2
# project_before_gather: the split block's backward against an f64 plain
# block on the CPU may err at most this many times the plain f32 block's
# own error, per gradient (the error below 1e-7 counts as 1e-7)
PBG_ERROR_FACTOR = 4.0
# host_native: the host C++ graph builders against their plain versions on
# the host CPU, best of HOST_REPEATS each: FaceToEdge on tet_grid(32)'s faces
# (the XDMF phases' mesh), k-hop at HOST_HOPS on the 16,384-node grid
# (chip_partition.MESH), the ELL grouping of the cylinder batch's graph
# (HOST_ELL_GRAPHS meshes of triangulated_grid(64, 32) as one graph)
HOST_REPEATS = 3
HOST_TET_GRID = 32
HOST_GRID = (128, 128)
HOST_HOPS = (2, 3)
HOST_ELL_MESH, HOST_ELL_GRAPHS = (64, 32), 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseClock:
    """Prints each phase's line with the seconds since the line before it
    (or hands it to ``sink``)."""

    def __init__(self, sink=emit):
        self.last = time.perf_counter()
        self.sink = sink

    def emit(self, obj) -> None:
        now = time.perf_counter()
        self.sink({**obj, "phase_s": now - self.last})
        self.last = now


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, inputs, min_reps=20, replays=5) -> float:
    """Device time of one ``fn(*args)`` call: a CUDA graph of calls cycling
    through ``inputs`` (copies sized to stream from device memory rather than
    L2), replayed and timed with CUDA events, so host overhead is excluded."""
    reps = max(min_reps, len(inputs))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in inputs[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def launch_floor_ms() -> float:
    """``device_ms`` of a one-element PyTorch elementwise kernel: the least
    time any kernel takes under that CUDA-graph replay."""
    one = torch.zeros(1, device="cuda")
    return device_ms(lambda t: t.add_(1.0), [(one,)])


def call_ms(fn, iters=20) -> float:
    """Eager time of one call, host included: CUDA events around ``iters``
    back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_past_l2(bytes_moved: int) -> int:
    return max(1, math.ceil(2 * L2_BYTES / bytes_moved))


def _category(kernel: str) -> str:
    k = kernel.lower()
    if "csr_attention_bwd" in k:
        return "csr_attention_bwd"
    if "csr_attention" in k:
        return "csr_attention"
    if "csr_segment_sum_bwd" in k:
        return "csr_segment_sum_bwd"
    if "csr_segment_sum" in k:
        return "csr_segment_sum"
    if "softmax_spmm_bwd" in k:
        return "softmax_spmm_bwd"
    if "softmax_spmm" in k:
        return "softmax_spmm"
    if "multi_tensor" in k or "adam" in k:
        return "optimizer"
    if "indexfunc" in k or "index_add" in k or "scatter" in k:
        return "index_add_scatter"
    if "gemm" in k or "cutlass" in k or "sm90_" in k:
        return "gemm"
    if "indexselect" in k or "index_select" in k or "gather" in k:
        return "gather"
    if "cat" in k:
        return "cat"
    if "reduce" in k:
        return "reduce"
    return "elementwise_other"


def device_breakdown(fn, frames: int, unit: str = "frame"):
    """Device time of ``fn`` (a rollout of ``frames`` frames, or ``frames``
    train steps with ``unit="step"``) by kernel, from torch.profiler's CUDA
    activity; None where the profiler saw no kernel. The host's operators
    are not traced: nothing here reads them, and reading their trace back
    took the host seconds a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # user-annotated ranges (the optimizer's step) span kernels counted on
    # their own rows: summing both would count that time twice
    rows = [r for r in prof.key_averages()
            if r.device_type == DeviceType.CUDA and not getattr(r, "is_user_annotation", False)]
    if not rows:
        return None

    def us(r):
        return getattr(r, "self_device_time_total", None) or getattr(r, "self_cuda_time_total", 0.0)

    total_us = sum(us(r) for r in rows)
    per = f"ms_per_{unit}"
    groups = {}
    for r in rows:
        g = groups.setdefault(_category(r.key), {per: 0.0, f"kernels_per_{unit}": 0.0})
        g[per] += us(r) / 1e3 / frames
        g[f"kernels_per_{unit}"] += r.count / frames
    top = sorted(rows, key=us, reverse=True)[:8]
    return {
        f"device_ms_per_{unit}": total_us / 1e3 / frames,
        f"kernels_per_{unit}": sum(r.count for r in rows) / frames,
        "by_category": groups,
        "top_kernels": [
            {"name": r.key[:90], per: us(r) / 1e3 / frames, f"count_per_{unit}": r.count / frames}
            for r in top
        ],
    }


def host_cpu() -> str:
    """The host CPU: its model (``/proc/cpuinfo``, where it names one), its
    architecture and its core count."""
    import platform

    model = "model not named"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.split(":", 1)[0].strip() in ("model name", "Model", "Hardware")),
                         model)
    except OSError:
        pass
    return f"{model}, {platform.machine()}, {os.cpu_count()} cores"


def host_native() -> dict:
    """The host C++ graph builders (``graphphysics_torch.native``) that the
    data path's ``face_to_edge``, ``k_hop_edges`` and ``build_ell`` run,
    each against its plain numpy / scipy version on the same input, on the
    host CPU of the card's machine: wall ms, best of ``HOST_REPEATS``, and
    the plain version's ms over the C++'s. Raises unless every output is
    bit-equal (arrays and dtypes)."""
    from graphphysics_torch.topology import build as topo
    from graphphysics_torch.topology import ell
    from graphphysics_torch.utils.synthetic import tet_grid, triangulated_grid

    def best(fn, *args, **kwargs):
        times, out = [], None
        for _ in range(HOST_REPEATS):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times), out

    def compare(name, native_fn, plain_fn, *args, **kwargs):
        cpp_ms, got = best(native_fn, *args, **kwargs)
        plain_ms, want = best(plain_fn, *args, **kwargs)
        same = len(got) == len(want) and all(
            a.dtype == b.dtype and np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
            for a, b in zip(got, want))
        if not same:
            raise AssertionError(f"host_native:{name}: the C++ output differs from the plain version's")
        return {"cpp_ms": cpp_ms, "plain_ms": plain_ms, "plain_over_cpp": plain_ms / cpp_ms,
                "bit_equal": True, "output_rows": int(len(got[0]))}

    faces = topo.tetra_to_faces(tet_grid(HOST_TET_GRID)[1])
    out = {"host_cpu": host_cpu(), "repeats": HOST_REPEATS,
           "face_to_edge": {"input": f"tetra_to_faces(tet_grid({HOST_TET_GRID})), {len(faces)} faces",
                            **compare("face_to_edge", topo.face_to_edge, topo.face_to_edge_reference,
                                      faces)}}
    s, r = topo.face_to_edge(triangulated_grid(*HOST_GRID)[1])
    n = HOST_GRID[0] * HOST_GRID[1]
    for k in HOST_HOPS:
        out[f"k_hop_edges_k{k}"] = {
            "input": f"triangulated_grid{HOST_GRID}, {n} nodes, {len(s)} edges",
            **compare(f"k_hop_edges_k{k}", topo.k_hop_edges, topo.k_hop_edges_reference, s, r, n, k)}
    s, r = topo.face_to_edge(triangulated_grid(*HOST_ELL_MESH)[1])
    per = HOST_ELL_MESH[0] * HOST_ELL_MESH[1]
    s = np.concatenate([s + i * per for i in range(HOST_ELL_GRAPHS)])
    r = np.concatenate([r + i * per for i in range(HOST_ELL_GRAPHS)])
    out["build_ell"] = {
        "input": f"{HOST_ELL_GRAPHS} x triangulated_grid{HOST_ELL_MESH}, {HOST_ELL_GRAPHS * per} nodes, "
                 f"{len(s)} edges",
        **compare("build_ell", ell.build_ell, ell.build_ell_reference, s, r, HOST_ELL_GRAPHS * per)}
    return out


def random_graph(n, e, n_pad, e_pad, seed):
    """A receiver-sorted padded graph with the cylinder feature layout
    ``[vel_x, vel_y, node_type, time]`` and random topology."""
    from graphphysics_torch.core import pad_graph_sorted_np

    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, size=n)
    return pad_graph_sorted_np(
        x,
        r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n, size=e).astype(np.int32),
        r.integers(0, n, size=e).astype(np.int32),
        n_pad,
        e_pad,
        edge_attr=r.normal(size=(e, 3)).astype(np.float32),
        y=r.normal(size=(n, 2)).astype(np.float32),
        node_type_index=2,
    )


def random_csr_graph(n, e, n_pad, e_pad, seed, senders_below=None, columns=5, node_type_index=3):
    """A sender-sorted (CSR) padded graph with the panels feature layout
    ``[vel(3), node_type, time]`` (or ``columns`` features with the node type
    at ``node_type_index``), 3 outputs, no edge features and random topology;
    senders are drawn below ``senders_below`` (default: every node)."""
    from graphphysics_torch.core import pad_graph_csr_np

    r = np.random.default_rng(seed)
    x = r.normal(size=(n, columns)).astype(np.float32)
    x[:, node_type_index] = r.integers(0, 7, size=n)
    return pad_graph_csr_np(
        x,
        r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n if senders_below is None else senders_below, size=e).astype(np.int32),
        r.integers(0, n, size=e).astype(np.int32),
        n_pad,
        e_pad,
        y=r.normal(size=(n, 3)).astype(np.float32),
        node_type_index=node_type_index,
    )


def aneurysm_gmm_graph(seed):
    """One sender-sorted graph at the aneurysm scale with the c-a-gmm
    layout: 14 features, the node type at index 14, 3 outputs."""
    return random_csr_graph(*ANEURYSM, seed, columns=15, node_type_index=14)


def gmm_trajectory(seed, frames):
    """``frames`` stacked frames of one aneurysm-scale graph
    (``aneurysm_gmm_graph``) whose 14 features drift by a fixed random step
    a frame, each frame's target the next frame's first 3 features."""
    from graphphysics_torch.core import stack_graphs

    base = aneurysm_gmm_graph(seed)
    step = np.random.default_rng(seed + 1).normal(scale=0.05, size=(base.num_nodes, 14))
    step = (step * base.node_mask[:, None]).astype(np.float32)
    xs = []
    for t in range(frames + 1):
        x = base.x.copy()
        x[:, :14] += t * step
        xs.append(x)
    return stack_graphs([base.replace(x=xs[t], y=xs[t + 1][:, :3].copy()) for t in range(frames)])


def flagship_graphs(seed):
    """The cylinder workload batch's 8 receiver-sorted graphs."""
    return [random_graph(n, e, 2048, 12288, seed + i)
            for i, (n, e) in enumerate(zip(BATCH_NODES, BATCH_EDGES))]


def flagship_batch(seed):
    """The cylinder workload batch: its 8 graphs concatenated."""
    from graphphysics_torch.core import concat_graphs

    return concat_graphs(flagship_graphs(seed))


def panels_graphs(seed):
    """The panels_csr workload batch's 8 sender-sorted graphs, one of them
    with empty softmax rows."""
    return [random_csr_graph(n, e, 2048, 12288, seed + i,
                             senders_below=EMPTY_ROWS_SENDERS if i == EMPTY_ROWS_GRAPH else None)
            for i, (n, e) in enumerate(zip(BATCH_NODES, BATCH_EDGES))]


def panels_batch(seed):
    """The panels_csr workload batch: its 8 graphs concatenated."""
    from graphphysics_torch.core import concat_graphs

    return concat_graphs(panels_graphs(seed))


def k1_case(name, graph, seed):
    """Hold csr_segment_sum against its plain version on one edge layout;
    the record names the lane geometry that ran and a digest of the
    output, so a run of another commit on the same seed shows whether the
    bits moved."""
    from chip_stream import digest
    from graphphysics_torch.ops.csr_segment import (
        alignment,
        csr_segment_sum,
        csr_segment_sum_reference,
        segment_sum_geometry,
    )

    dev = torch.device("cuda")
    recv = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.row_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n = recv.shape[0], bounds.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = torch.randn((e, HIDDEN), generator=gen, device=dev)

    with torch.no_grad():
        got = csr_segment_sum(data, recv, bounds, mask)
        again = csr_segment_sum(data, recv, bounds, mask)
        want = csr_segment_sum_reference(data, recv, n, mask)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: K1 not bit-equal on a second run")
        err = (got - want).abs().max().item()
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"{name}: kernel vs plain max_abs_err {err} > {KERNEL_ATOL}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel output not finite")
        # the yardstick sums the same function: masked rows zeroed beforehand
        lib_data = torch.where(mask[:, None], data, torch.zeros((), device=dev))

        def library(d, r):
            return torch.zeros((n, HIDDEN), device=dev).index_add_(0, r, d)

        lib_err = (library(lib_data, recv) - want).abs().max().item()

        # the kernel walks only the row ranges, which stop before the
        # padding: each real edge's data row and mask byte, each node's two
        # bounds and output row
        real_edges = int(mask.sum().item())
        bytes_moved = real_edges * (HIDDEN * 4 + 1) + n * (8 + HIDDEN * 4)
        copies = copies_past_l2(bytes_moved)
        datas = [data] + [data.clone() for _ in range(copies - 1)]
        libs = [lib_data] + [lib_data.clone() for _ in range(copies - 1)]
        kernel_t = device_ms(lambda d: csr_segment_sum(d, recv, bounds, mask), [(d,) for d in datas])
        plain_t = device_ms(lambda d: csr_segment_sum_reference(d, recv, n, mask), [(d,) for d in datas])
        library_t = device_ms(lambda d: library(d, recv), [(d,) for d in libs])
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_bound = real_edges * HIDDEN / H100_F32_OPS_PER_S * 1e3  # one f32 add per edge and column
    return {
        "shape": name,
        "nodes": n,
        "edges": e,
        "real_edges": real_edges,
        "hidden": HIDDEN,
        "max_abs_err": err,
        "tolerance": KERNEL_ATOL,
        "geometry": segment_sum_geometry(HIDDEN, data.dtype, alignment(data))._asdict(),
        "digest": digest(got),
        "bit_equal_twice": True,
        "library_max_abs_err": lib_err,
        "ms": kernel_t,
        "plain_ms": plain_t,
        "library_ms": library_t,
        "bound_ms": max(bound, ops_bound),
        "bound_by": "bytes" if bound >= ops_bound else "operations",
        "bytes": bytes_moved,
        "input_copies": copies,
    }


def k1_geometry_cases(graph, seed) -> list:
    """The f32 K1 in each geometry its rule gives at the cylinder batch's
    layout: widths 128 and 64 (16-byte words, one and two rows a warp), 48
    (16-byte words, four idle lanes of 16) and 130 (not a multiple of 4:
    single columns), each on data 16- and 4-byte aligned (words, single
    columns). Each within ``KERNEL_ATOL`` of its plain version, the same
    bits twice, and the same bits in both geometries of a width (each
    adds a row's edges in edge order in f32). Then a hub row of 4,096 unit
    edges in both geometries: exactly 4,096."""
    from chip_stream import HUB_EDGES, digest, view_at
    from graphphysics_torch.ops.csr_segment import (
        alignment,
        compute_row_bounds,
        csr_segment_sum,
        csr_segment_sum_reference,
        segment_sum_geometry,
    )

    dev = torch.device("cuda")
    recv = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.row_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    n = bounds.shape[1]
    records = []
    for width in K1_F32_WIDTHS:
        gen = torch.Generator(device=dev).manual_seed(seed + width)
        data = torch.randn((recv.shape[0], width), generator=gen, device=dev)
        with torch.no_grad():
            want = csr_segment_sum_reference(data, recv, n, mask)
            outs, kinds, worst = [], [], 0.0
            for aligned in K1_F32_ALIGNMENTS:
                d = view_at(data, aligned)
                got, again = (csr_segment_sum(d, recv, bounds, mask) for _ in range(2))
                torch.cuda.synchronize()
                kinds.append(segment_sum_geometry(width, d.dtype, alignment(d)).kind)
                worst = max(worst, (got - want).abs().max().item())
                if not torch.equal(got, again) or not worst <= KERNEL_ATOL:
                    raise AssertionError(f"f32 K1 at width {width}, {kinds[-1]}: max_abs_err {worst}, "
                                         f"bit-equal twice {torch.equal(got, again)}")
                outs.append(got)
        if not all(torch.equal(o, outs[0]) for o in outs[1:]):
            raise AssertionError(f"f32 K1 at width {width}: geometries {kinds} give different bits")
        records.append({"entry": "csr_segment_sum_f32", "width": width, "aligned": K1_F32_ALIGNMENTS,
                        "geometries": kinds, "max_abs_err": worst, "tolerance": KERNEL_ATOL,
                        "bit_equal_twice": True, "bit_equal_across_geometries": True,
                        "digest": digest(outs[0])})
    hub_n = 64
    recv_np = np.concatenate([np.zeros(HUB_EDGES, np.int32), np.arange(1, hub_n, dtype=np.int32)])
    hub_recv = torch.from_numpy(recv_np).to(dev)
    hub_bounds = torch.from_numpy(compute_row_bounds(recv_np, hub_n)).to(dev)
    outs, kinds = [], []
    for aligned in K1_F32_ALIGNMENTS:
        ones = view_at(torch.ones((len(recv_np), HIDDEN), device=dev), aligned)
        with torch.no_grad():
            out = csr_segment_sum(ones, hub_recv, hub_bounds)
        kinds.append(segment_sum_geometry(HIDDEN, ones.dtype, alignment(ones)).kind)
        if not (bool((out[0] == HUB_EDGES).all()) and bool((out[1:] == 1).all())):
            raise AssertionError(f"f32 hub row, {kinds[-1]}: read {out[0].min().item()}-{out[0].max().item()}, "
                                 f"expected {HUB_EDGES}")
        outs.append(out)
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"f32 hub row: geometries {kinds} give different bits")
    records.append({"entry": "csr_segment_sum_f32", "width": HIDDEN, "hub_edges": HUB_EDGES,
                    "hub_row": outs[0][0].min().item(), "geometries": kinds, "bit_equal_across_geometries": True})
    return records


def k2_case(name, graph, width, seed, heads=HEADS):
    """Hold csr_softmax_spmm against its plain version on one sender-sorted
    layout, with scores masked as csr_sparse_attention masks them; the
    record names the geometry that ran (for a general one, its adjacent or
    strided columns) and a digest of the output (the same bits on a second
    run)."""
    from chip_stream import digest
    from graphphysics_torch.ops.csr_attention import (
        NEG,
        csr_softmax_spmm,
        csr_softmax_spmm_reference,
        softmax_spmm_columns,
        softmax_spmm_geometry,
        softmax_spmm_kind,
    )

    dev = torch.device("cuda")
    seg = torch.as_tensor(graph.senders).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n, h = seg.shape[0], bounds.shape[1], heads
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = 3 * torch.randn((e, h), generator=gen, device=dev)
    scores = torch.where(mask[:, None], scores, torch.full((), NEG, device=dev))
    values = torch.randn((e, width), generator=gen, device=dev)

    with torch.no_grad():
        out, ml = csr_softmax_spmm(scores, values, seg, bounds, mask)
        again, again_ml = csr_softmax_spmm(scores, values, seg, bounds, mask)
        want_out, want_ml = csr_softmax_spmm_reference(scores, values, seg, n, mask)
        torch.cuda.synchronize()
        if not (torch.equal(out, again) and torch.equal(ml, again_ml)):
            raise AssertionError(f"{name}: K2 not bit-equal on a second run")
        err = (out - want_out).abs().max().item()
        ml_err = (ml - want_ml).abs().max().item()
        for got, want, what in ((out, want_out, "out"), (ml, want_ml, "ml")):
            if not torch.allclose(got, want, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL):
                bad = (got - want).abs().max().item()
                raise AssertionError(f"{name}: kernel vs plain {what} max_abs_err {bad}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name}: kernel output not finite")
        empty_rows = int((want_ml[h:] == 0).all(dim=0).sum().item())

        # the kernel walks only the row ranges, which stop before the
        # padding: each real edge's scores, value row and mask byte; each
        # node's output row, (m, l) per head and two bounds. The segment ids
        # are not read: the ranges carry them.
        real_edges = int(mask.sum().item())
        bytes_moved = real_edges * (4 * h + 4 * width + 1) + n * (4 * width + 8 * h + 8)
        copies = copies_past_l2(bytes_moved)
        inputs = [(scores, values)] + [
            (scores.clone(), values.clone()) for _ in range(copies - 1)
        ]
        kernel_t = device_ms(lambda s, v: csr_softmax_spmm(s, v, seg, bounds, mask), inputs)
        plain_t = device_ms(lambda s, v: csr_softmax_spmm_reference(s, v, seg, n, mask), inputs)
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    # f32 operations: per real edge and column a multiply-add into the sum,
    # per real edge and head a max, an exponential and an add into l; per
    # output element one division
    ops = real_edges * (2 * width + 3 * h) + n * width
    ops_bound = ops / H100_F32_OPS_PER_S * 1e3
    return {
        "shape": name,
        "nodes": n,
        "edges": e,
        "real_edges": real_edges,
        "empty_rows": empty_rows,
        "width": width,
        "heads": h,
        "max_abs_err": err,
        "ml_max_abs_err": ml_err,
        "tolerance": {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL},
        "geometry": softmax_spmm_geometry(width, h)._asdict(),
        "columns": (softmax_spmm_columns(width, h, 16) if softmax_spmm_geometry(width, h).kind == "general"
                    else None),
        "kind": softmax_spmm_kind(width, h, 16),
        "digest": digest(out),
        "ml_digest": digest(ml),
        "bit_equal_twice": True,
        "ms": kernel_t,
        "plain_ms": plain_t,
        "library_ms": None,
        "library_note": "no single PyTorch call computes a segment softmax + SpMM",
        "bound_ms": max(bound, ops_bound),
        "bound_by": "bytes" if bound >= ops_bound else "operations",
        "bytes": bytes_moved,
        "operations": ops,
        "input_copies": copies,
    }


def _geometry_case_inputs(graph, width, heads, aligned, seed):
    """``k2_f32_geometry_cases``' inputs of one case on the card: the
    layout, scores masked as ``k2_case`` masks them, the values at
    ``aligned`` bytes."""
    from chip_stream import view_at
    from graphphysics_torch.ops import csr_attention as ca

    dev = torch.device("cuda")
    seg = torch.as_tensor(graph.senders).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e = seg.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.where(mask[:, None], 3 * torch.randn((e, heads), generator=gen, device=dev),
                         torch.full((), ca.NEG, device=dev))
    values = view_at(torch.randn((e, width), generator=gen, device=dev), aligned)
    return seg, bounds, mask, scores, values


def geometry_case_ms(fn, scores, values, aligned, bytes_moved) -> float:
    """``device_ms`` of ``fn(scores, values)`` over copies past L2, each
    copy's values placed at ``aligned`` bytes as the case's own are (a
    clone would sit at the allocator's alignment and take another
    geometry)."""
    from chip_stream import view_at

    copies = copies_past_l2(bytes_moved)
    inputs = [(scores, values)] + [(scores.clone(), view_at(values, aligned)) for _ in range(copies - 1)]
    with torch.no_grad():
        return device_ms(fn, inputs)


def k2_f32_geometry_cases(graph, seed) -> list:
    """The f32 K2 in each geometry its rule gives (``K2_F32_GEOMETRY_CASES``)
    on one sender-sorted layout, scores masked as ``k2_case`` masks them:
    each within ``SOFTMAX_RTOL``/``ATOL`` of its plain version, the same
    bits twice, and its rows without a live edge exactly out = 0,
    m = -1e30, l = 0; each timed beside its bound (``k2_case``'s bytes),
    so two geometries of one width stand side by side."""
    from chip_stream import digest
    from graphphysics_torch.ops import csr_attention as ca

    tol = {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL}
    records = []
    for i, (width, heads, aligned) in enumerate(K2_F32_GEOMETRY_CASES):
        seg, bounds, mask, scores, values = _geometry_case_inputs(graph, width, heads, aligned, seed + i)
        n = bounds.shape[1]
        with torch.no_grad():
            out, ml = ca.csr_softmax_spmm(scores, values, seg, bounds, mask)
            again, again_ml = ca.csr_softmax_spmm(scores, values, seg, bounds, mask)
            want_out, want_ml = ca.csr_softmax_spmm_reference(scores, values, seg, n, mask)
            torch.cuda.synchronize()
        geometry = ca.softmax_spmm_geometry(width, heads, aligned)
        columns = ca.softmax_spmm_columns(width, heads, aligned) if geometry.kind == "general" else None
        label = f"width {width}, {heads} heads, {aligned}-byte values, {geometry.kind} {columns or ''}"
        errs = [(out - want_out).abs().max().item(), (ml - want_ml).abs().max().item()]
        if not (torch.equal(out, again) and torch.equal(ml, again_ml)):
            raise AssertionError(f"f32 K2 at {label}: not bit-equal on a second run")
        if not (torch.isfinite(out).all() and torch.allclose(out, want_out, **tol)
                and torch.allclose(ml, want_ml, **tol)):
            raise AssertionError(f"f32 K2 at {label} vs plain out/ml max_abs_err {errs}")
        empty = (want_ml[heads:] == 0).all(dim=0)
        if not (bool((out[empty] == 0).all()) and bool((ml[:heads, empty] == ca.NEG).all())
                and bool((ml[heads:, empty] == 0).all())):
            raise AssertionError(f"f32 K2 at {label}: a row without a live edge is not out 0, m -1e30, l 0")
        real_edges = int(mask.sum().item())
        bytes_moved = real_edges * (4 * heads + 4 * width + 1) + n * (4 * width + 8 * heads + 8)
        ms = geometry_case_ms(lambda s, v: ca.csr_softmax_spmm(s, v, seg, bounds, mask), scores, values, aligned,
                              bytes_moved)
        records.append({"entry": "csr_softmax_spmm_f32", "width": width, "heads": heads, "aligned": aligned,
                        "geometry": geometry._asdict(), "columns": columns,
                        "kind": ca.softmax_spmm_kind(width, heads, aligned), "max_abs_err": max(errs),
                        "out_ml_max_abs_err": errs, "tolerance": tol, "bit_equal_twice": True,
                        "empty_rows": int(empty.sum().item()), "digest": digest(out), "ms": ms,
                        "bound_ms": bytes_moved / H100_BYTES_PER_S * 1e3})
    return records


def k3_f32_geometry_cases(graph, seed) -> list:
    """K3 at each case of ``K2_F32_GEOMETRY_CASES`` (``k2_f32_geometry_cases``'
    inputs, the forward's ml and out, a random gradient of out): within
    ``K3_RTOL``/``ATOL`` of its plain version, the same bits twice, exactly
    0 on masked and padded edges; each timed beside its bound (``k3_case``'s
    bytes)."""
    from chip_stream import digest
    from graphphysics_torch.ops import csr_attention as ca

    tol = {"rtol": K3_RTOL, "atol": K3_ATOL}
    records = []
    for i, (width, heads, aligned) in enumerate(K2_F32_GEOMETRY_CASES):
        seg, bounds, mask, scores, values = _geometry_case_inputs(graph, width, heads, aligned, seed + i)
        n = bounds.shape[1]
        g = torch.randn((n, width), generator=torch.Generator(device="cuda").manual_seed(seed + 100 + i),
                        device="cuda")
        with torch.no_grad():
            out, ml = ca.csr_softmax_spmm(scores, values, seg, bounds, mask)
            got = ca.csr_softmax_spmm_backward(scores, values, seg, bounds, ml, out, g, mask)
            again = ca.csr_softmax_spmm_backward(scores, values, seg, bounds, ml, out, g, mask)
            want = ca.csr_softmax_spmm_backward_reference(scores, values, seg, ml, out, g, mask)
            torch.cuda.synchronize()
        columns = ca.softmax_spmm_columns(width, heads, aligned)
        label = f"width {width}, {heads} heads, {aligned}-byte values, {columns} columns"
        errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K3 at {label}: not bit-equal on a second run")
        for a, b in zip(got, want):
            if not (torch.isfinite(a).all() and bool((a[~mask] == 0).all()) and torch.allclose(a, b, **tol)):
                raise AssertionError(f"K3 at {label} vs plain dscores/dvalues max_abs_err {errs}, or not 0 "
                                     "on masked edges")
        real_edges, e = int(mask.sum().item()), mask.shape[0]
        bytes_moved = (real_edges * (4 * heads + 4 * width + 1) + n * (8 * width + 8 * heads + 8)
                       + e * (4 * heads + 4 * width))
        ms = geometry_case_ms(lambda s, v: ca.csr_softmax_spmm_backward(s, v, seg, bounds, ml, out, g, mask),
                              scores, values, aligned, bytes_moved)
        records.append({"entry": "csr_softmax_spmm_bwd_f32", "width": width, "heads": heads, "aligned": aligned,
                        "columns": columns, "kind": ca.softmax_spmm_kind(width, heads, aligned, backward=True),
                        "max_abs_err": max(errs), "dscores_dvalues_max_abs_err": errs,
                        "tolerance": tol, "bit_equal_twice": True, "digest": [digest(t) for t in got], "ms": ms,
                        "bound_ms": bytes_moved / H100_BYTES_PER_S * 1e3})
    return records


def unsplit_part0(seed):
    """Part 0 of the 4-way unsplit halo partition of the 16,384-node mesh
    (``chip_partition.mesh_graph``), as the unsplit partitioned
    transformer hands it to K2 and K3: its edges segmented by their local
    receivers over the part's row ranges. Named as ``k2_case`` and
    ``k3_case`` read a layout (``senders``, ``sender_bounds``,
    ``edge_mask``)."""
    from types import SimpleNamespace

    from chip_partition import PARTS, mesh_graph
    from graphphysics_torch.parallel.graph_partition import partition_graph_halo_np

    part = partition_graph_halo_np(mesh_graph("csr", seed), PARTS)[0]
    return SimpleNamespace(senders=np.asarray(part.receivers), sender_bounds=np.asarray(part.row_bounds),
                           edge_mask=np.asarray(part.edge_mask))


def k1b_case(name, graph, seed):
    """Hold csr_segment_sum_backward against its plain version on one edge
    layout, and autograd through csr_segment_sum against autograd of the
    plain forward."""
    from graphphysics_torch.ops.csr_segment import (
        csr_segment_sum,
        csr_segment_sum_backward,
        csr_segment_sum_backward_reference,
        csr_segment_sum_reference,
    )

    dev = torch.device("cuda")
    recv = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.row_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n = recv.shape[0], bounds.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn((n, HIDDEN), generator=gen, device=dev)
    data = torch.randn((e, HIDDEN), generator=gen, device=dev)

    got = csr_segment_sum_backward(g, recv, bounds, mask)
    want = csr_segment_sum_backward_reference(g, recv, bounds, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= GATHER_ATOL or not bool((got[~mask] == 0).all()):
        raise AssertionError(f"{name}: K1b vs plain max_abs_err {err} > {GATHER_ATOL}")
    d = data.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(csr_segment_sum(d, recv, bounds, mask), d, g)
    d = data.clone().requires_grad_(True)
    (grad_plain,) = torch.autograd.grad(csr_segment_sum_reference(d, recv, n, mask), d, g)
    grad_err = (grad - grad_plain).abs().max().item()
    if not grad_err <= GATHER_ATOL:
        raise AssertionError(f"{name}: autograd through K1 vs plain max_abs_err {grad_err}")

    # every edge row is written; each node's g row and bounds read once;
    # each edge's receiver and mask byte read
    bytes_moved = e * HIDDEN * 4 + e * (4 + 1) + n * (HIDDEN * 4 + 8)
    copies = copies_past_l2(bytes_moved)
    gs = [(g,)] + [(g.clone(),) for _ in range(copies - 1)]
    with torch.no_grad():
        kernel_t = device_ms(lambda x: csr_segment_sum_backward(x, recv, bounds, mask), gs)
        plain_t = device_ms(lambda x: csr_segment_sum_backward_reference(x, recv, bounds, mask), gs)
        library_t = device_ms(lambda x: x.index_select(0, recv), gs)
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    return {
        "shape": name,
        "nodes": n,
        "edges": e,
        "real_edges": int(mask.sum().item()),
        "hidden": HIDDEN,
        "max_abs_err": err,
        "tolerance": GATHER_ATOL,
        "autograd_max_abs_err": grad_err,
        "ms": kernel_t,
        "plain_ms": plain_t,
        "library_ms": library_t,
        "library_note": "index_select(0, receivers): the same gather without zeroing masked and padded edges",
        "bound_ms": bound,
        "bound_by": "bytes",
        "bytes": bytes_moved,
        "input_copies": copies,
    }


def k3_case(name, graph, width, seed, heads=HEADS):
    """Hold csr_softmax_spmm_backward against its plain version on one
    sender-sorted layout (scores masked as csr_sparse_attention masks
    them), and autograd through csr_softmax_spmm against autograd of the
    plain forward; the record names K3's columns (the V-column kernel's
    adjacent ones, or the general geometry's strided ones) and a digest of
    the gradients."""
    from chip_stream import digest
    from graphphysics_torch.ops.csr_attention import (
        NEG,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
        csr_softmax_spmm_backward_reference,
        csr_softmax_spmm_reference,
        softmax_spmm_columns,
        softmax_spmm_kind,
    )

    dev = torch.device("cuda")
    seg = torch.as_tensor(graph.senders).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    e, n, h = seg.shape[0], bounds.shape[1], heads
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = 3 * torch.randn((e, h), generator=gen, device=dev)
    scores = torch.where(mask[:, None], scores, torch.full((), NEG, device=dev))
    values = torch.randn((e, width), generator=gen, device=dev)
    g = torch.randn((n, width), generator=gen, device=dev)
    with torch.no_grad():
        out, ml = csr_softmax_spmm(scores, values, seg, bounds, mask)

    got = csr_softmax_spmm_backward(scores, values, seg, bounds, ml, out, g, mask)
    want = csr_softmax_spmm_backward_reference(scores, values, seg, ml, out, g, mask)
    torch.cuda.synchronize()
    errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
    for a, b, what in zip(got, want, ("dscores", "dvalues")):
        if not torch.isfinite(a).all() or not bool((a[~mask] == 0).all()):
            raise AssertionError(f"{name}: K3 {what} not finite, or not 0 on masked edges")
        if not torch.allclose(a, b, rtol=K3_RTOL, atol=K3_ATOL):
            raise AssertionError(f"{name}: K3 vs plain {what} max_abs_err {(a - b).abs().max().item()}")

    def grads_of(forward):
        s_, v_ = scores.clone().requires_grad_(True), values.clone().requires_grad_(True)
        return torch.autograd.grad(forward(s_, v_)[0], (s_, v_), g)

    kernel_grads = grads_of(lambda s_, v_: csr_softmax_spmm(s_, v_, seg, bounds, mask))
    plain_grads = grads_of(lambda s_, v_: csr_softmax_spmm_reference(s_, v_, seg, n, mask))
    grad_errs = [(a - b).abs().max().item() for a, b in zip(kernel_grads, plain_grads)]
    for a, b in zip(kernel_grads, plain_grads):
        if not torch.allclose(a, b, rtol=K3_GRAD_RTOL, atol=K3_GRAD_ATOL):
            raise AssertionError(f"{name}: autograd through K2/K3 vs plain max_abs_err {grad_errs}")

    # reads: each real edge's scores, value row and mask byte; each node's
    # out and g rows, (m, l) per head and two bounds. Writes: every edge's
    # dscores and dvalues rows, padding included.
    real_edges = int(mask.sum().item())
    bytes_moved = (real_edges * (4 * h + 4 * width + 1) + n * (8 * width + 8 * h + 8)
                   + e * (4 * h + 4 * width))
    copies = copies_past_l2(bytes_moved)
    inputs = [(scores, values, ml, out, g)] + [
        tuple(t.clone() for t in (scores, values, ml, out, g)) for _ in range(copies - 1)
    ]
    with torch.no_grad():
        kernel_t = device_ms(
            lambda s_, v_, ml_, o_, g_: csr_softmax_spmm_backward(s_, v_, seg, bounds, ml_, o_, g_, mask),
            inputs)
        plain_t = device_ms(
            lambda s_, v_, ml_, o_, g_: csr_softmax_spmm_backward_reference(s_, v_, seg, ml_, o_, g_, mask),
            inputs)
    bound = bytes_moved / H100_BYTES_PER_S * 1e3
    # f32 operations per real edge: per head an exponential, a division and
    # the dscores product; per column the dvalues product and the dot's
    # multiply-add; per node and column the delta multiply-add
    ops = real_edges * (3 * width + 3 * h) + n * 2 * width
    ops_bound = ops / H100_F32_OPS_PER_S * 1e3
    return {
        "shape": name,
        "nodes": n,
        "edges": e,
        "real_edges": real_edges,
        "empty_rows": int((ml[h:] == 0).all(dim=0).sum().item()),
        "width": width,
        "heads": h,
        "max_abs_err": max(errs),
        "dscores_dvalues_max_abs_err": errs,
        "tolerance": {"rtol": K3_RTOL, "atol": K3_ATOL},
        "columns": softmax_spmm_columns(width, h, 16),
        "kind": softmax_spmm_kind(width, h, 16, backward=True),
        "digest": [digest(t) for t in got],
        "autograd_max_abs_err": grad_errs,
        "autograd_tolerance": {"rtol": K3_GRAD_RTOL, "atol": K3_GRAD_ATOL},
        "ms": kernel_t,
        "plain_ms": plain_t,
        "library_ms": None,
        "library_note": "no single PyTorch call computes the softmax + SpMM backward",
        "bound_ms": max(bound, ops_bound),
        "bound_by": "bytes" if bound >= ops_bound else "operations",
        "bytes": bytes_moved,
        "operations": ops,
        "input_copies": copies,
    }


def replaced_attention(q, k, v, seg, gather, bounds, mask, scale):
    """The transformer's attention as it ran before the fused kernels: the
    gathers and the per-head dot as PyTorch ops around K2
    (``csr_softmax_spmm``), differentiable through K3 and ``index_add_``."""
    from graphphysics_torch.ops.csr_attention import NEG, csr_softmax_spmm

    n, h, dh = q.shape
    d = h * dh
    q_e = q.reshape(n, d).index_select(0, seg)
    k_e = k.reshape(n, d).index_select(0, gather)
    v_e = v.reshape(n, d).index_select(0, gather)
    scores = (q_e * k_e).reshape(-1, h, dh).sum(dim=-1) * scale
    scores = torch.where(mask[:, None], scores, torch.full((), NEG, device=q.device))
    out, _ = csr_softmax_spmm(scores, v_e, seg, bounds, mask)
    return out.reshape(n, h, dh)


def dense_adjacency(seg, gather, mask, n):
    """The [N, N] boolean adjacency of the unmasked edges (row: the
    softmax side), for the SDPA yardstick, and the rows whose edges are
    all distinct and not empty (where SDPA computes the same function)."""
    adj = torch.zeros((n, n), dtype=torch.bool, device=seg.device)
    s, j = seg[mask].long(), gather[mask].long()
    adj[s, j] = True
    per_row = torch.zeros(n, dtype=torch.int64, device=seg.device).index_add_(0, s, torch.ones_like(s))
    return adj, (per_row == adj.sum(dim=1)) & (per_row > 0)


def attention_inputs(graph, width, seed, heads=HEADS, view="model"):
    """q, k, v and an output gradient at ``width`` with ``heads`` heads, in
    the layout the model's Attention passes ((N, Dh, H) memory) or, with
    ``view="contiguous"``, as contiguous [N, H, Dh], and the graph's device
    tensors."""
    dev = torch.device("cuda")
    seg = torch.as_tensor(graph.senders).to(dev)
    gather = torch.as_tensor(graph.receivers).to(dev)
    bounds = torch.as_tensor(graph.sender_bounds).to(dev)
    mask = torch.as_tensor(graph.edge_mask).to(dev)
    n, h = bounds.shape[1], heads
    gen = torch.Generator(device=dev).manual_seed(seed)
    if view == "model":
        qkvg = [torch.randn((n, width // h, h), generator=gen, device=dev).transpose(1, 2)
                for _ in range(4)]
    else:
        qkvg = [torch.randn((n, h, width // h), generator=gen, device=dev) for _ in range(4)]
    return seg, gather, bounds, mask, qkvg


def fused_case(name, graph, width, seed, library=True, heads=HEADS, view="model", replaced=True):
    """Hold both fused attention kernels (``csr_attention`` and
    ``csr_attention_backward``) against their plain versions on one
    sender-sorted layout at ``width`` with ``heads`` heads in the model's
    layout (or ``view="contiguous"``), and time each beside its bound, its
    plain version, at every lane count whose geometry the kernels take, with
    ``replaced`` the PyTorch path it replaced (gathers + SDDMM + K2;
    autograd through them with K3 and ``index_add_``; K2 takes widths that
    are multiples of 32 only) and, with ``library``, SDPA with the dense
    adjacency as its mask. Returns (forward record, backward record)."""
    from graphphysics_torch.ops import csr_attention as ca

    seg, gather, bounds, mask, (q, k, v, g) = attention_inputs(graph, width, seed, heads, view)
    n, h = bounds.shape[1], heads
    scale = h ** -0.5
    interleaved = ca._is_interleaved(q)
    with torch.no_grad():
        out, ml = ca.csr_attention(q, k, v, seg, gather, bounds, mask, scale)
        want_out, want_ml = ca.csr_attention_reference(q, k, v, seg, gather, n, mask, scale)
        grads = ca.csr_attention_backward(q, k, v, seg, gather, bounds, ml, out, g, mask, scale)
        want_grads = ca.csr_attention_backward_reference(q, k, v, seg, gather, ml, out, g, mask, scale)
    torch.cuda.synchronize()
    fwd_errs = [(a - b).abs().max().item() for a, b in ((out, want_out), (ml, want_ml))]
    for got, want, what in ((out, want_out, "out"), (ml, want_ml, "ml")):
        if not torch.isfinite(got).all() or not torch.allclose(got, want, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL):
            raise AssertionError(f"{name}: fused forward vs plain {what} max_abs_err {fwd_errs}")
    bwd_errs = [(a - b).abs().max().item() for a, b in zip(grads, want_grads)]
    for a, b in zip(grads, want_grads):
        if not torch.isfinite(a).all() or not torch.allclose(a, b, rtol=K3_GRAD_RTOL, atol=K3_GRAD_ATOL):
            raise AssertionError(f"{name}: fused backward vs plain dq/dk/dv max_abs_err {bwd_errs}")
    empty_rows = int((want_ml[h:] == 0).all(dim=0).sum().item())
    edges_read = int((bounds[1] - bounds[0]).clamp(min=0).sum().item())  # the ranges' edges
    real_edges = int(mask.sum().item())

    # bytes: q, k, v read once (the gathered rows are node rows, which fit
    # the L2), each range edge's gather index and mask byte, the bounds,
    # out and ml; the backward also reads out and g and writes dq, dk, dv
    row = 4 * width
    fwd_bytes = n * 3 * row + edges_read * 5 + n * 8 + n * row + n * 8 * h
    bwd_bytes = n * 5 * row + edges_read * 5 + n * 8 + n * 8 * h + n * 3 * row
    # f32 operations. Forward per real edge and column the dot's and the
    # sum's multiply-adds, per head the scale, a max, two exponentials and
    # l's update; per output element a division. Backward per real edge and
    # column the two dots, dq's, dk's and dv's products and adds; per head
    # an exponential, a division and ds; per node and column delta's.
    fwd_ops = real_edges * (4 * width + 6 * h) + n * width
    bwd_ops = real_edges * (11 * width + 6 * h) + n * 2 * width
    copies = copies_past_l2(fwd_bytes)
    sets = [(q, k, v, g)] + [tuple(t.clone() for t in (q, k, v, g)) for _ in range(copies - 1)]
    saved = []
    with torch.no_grad():
        for q_, k_, v_, _ in sets:
            saved.append(ca.csr_attention(q_, k_, v_, seg, gather, bounds, mask, scale))
    lanes = [x for x in ca.FORWARD_LANES if ca.geometry_kind(x, width, h, interleaved)]
    fwd_by_lanes, bwd_by_lanes = {}, {}
    with torch.no_grad():
        fwd_t = device_ms(lambda a, b, c, _: ca.csr_attention(a, b, c, seg, gather, bounds, mask, scale),
                          sets)
        bwd_inputs = [(*st, *sv) for st, sv in zip(sets, saved)]
        bwd_t = device_ms(
            lambda a, b, c, g_, o_, ml_: ca.csr_attention_backward(a, b, c, seg, gather, bounds, ml_, o_, g_,
                                                                   mask, scale), bwd_inputs)
        for x in lanes:
            fwd_by_lanes[x] = device_ms(lambda a, b, c, _: ca._launch_attention(
                a, b, c, gather, bounds, mask, scale, interleaved, lanes=x), sets)
            bwd_by_lanes[x] = device_ms(lambda a, b, c, g_, o_, ml_: ca._launch_attention_backward(
                a, b, c, gather, bounds, mask, ml_, o_, g_, scale, interleaved, lanes=x), bwd_inputs)
        fwd_plain = device_ms(
            lambda a, b, c, _: ca.csr_attention_reference(a, b, c, seg, gather, n, mask, scale), sets)
        bwd_plain = device_ms(
            lambda a, b, c, g_, o_, ml_: ca.csr_attention_backward_reference(
                a, b, c, seg, gather, ml_, o_, g_, mask, scale), bwd_inputs)
        fwd_replaced = device_ms(
            lambda a, b, c, _: replaced_attention(a, b, c, seg, gather, bounds, mask, scale),
            sets) if replaced else None

    def fwd_bwd(forward):
        def run(a, b, c, g_):
            leaves = [t.detach().requires_grad_(True) for t in (a, b, c)]
            return torch.autograd.grad(forward(*leaves), leaves, g_)
        return run

    fused_fb = device_ms(fwd_bwd(lambda a, b, c: ca.csr_sparse_attention(a, b, c, seg, gather, bounds, mask,
                                                                         scale)), sets)
    replaced_fb = device_ms(fwd_bwd(
        lambda a, b, c: replaced_attention(a, b, c, seg, gather, bounds, mask, scale)),
        sets) if replaced else None
    lib = {"library_ms": None, "library_fwd_bwd_ms": None,
           "library_note": (f"n/a: SDPA needs a dense [{n}, {n}] mask ({n * n / 1e9:.1f} GB as bool) "
                            f"and materializes f32 scores of {4 * h * n * n / 1e9:.0f} GB")}
    if library:
        import torch.nn.functional as F

        adj, same_rows = dense_adjacency(seg, gather, mask, n)

        def sdpa(a, b, c):  # [N, H, Dh] -> [1, H, N, Dh]
            return F.scaled_dot_product_attention(
                a.transpose(0, 1)[None], b.transpose(0, 1)[None], c.transpose(0, 1)[None],
                attn_mask=adj, scale=scale)[0].transpose(0, 1)

        with torch.no_grad():
            lib_err = (sdpa(q, k, v) - out)[same_rows].abs().max().item()
            lib_fwd = device_ms(lambda a, b, c, _: sdpa(a, b, c), sets, min_reps=3)
        lib_fb = device_ms(fwd_bwd(sdpa), sets, min_reps=3)
        lib = {"library_ms": lib_fwd, "library_fwd_bwd_ms": lib_fb,
               "library_max_abs_err": lib_err, "library_rows_compared": int(same_rows.sum().item()),
               "library_note": ("torch.nn.functional.scaled_dot_product_attention, dense boolean "
                                "adjacency mask, compared on rows with edges and no repeated edge "
                                "(SDPA counts a repeated edge once, and gives NaN on a row without one)")}
    fwd_lanes = ca.lanes_per_row(width, h, interleaved)
    bwd_lanes = ca.lanes_per_row(width, h, interleaved, backward=True)
    common = {"shape": name, "nodes": n, "edges": seg.shape[0], "real_edges": real_edges,
              "empty_rows": empty_rows, "width": width, "heads": h,
              "layout": "(N, Dh, H) view" if view == "model" else "contiguous [N, H, Dh]",
              "lanes_per_row": {"forward": fwd_lanes, "backward": bwd_lanes},
              "geometry": {"forward": ca.geometry_kind(fwd_lanes, width, h, interleaved),
                           "backward": ca.geometry_kind(bwd_lanes, width, h, interleaved)},
              "input_copies": copies,
              "fused_fwd_bwd_ms": fused_fb, "replaced_fwd_bwd_ms": replaced_fb}
    fwd_bound, fwd_ops_bound = fwd_bytes / H100_BYTES_PER_S * 1e3, fwd_ops / H100_F32_OPS_PER_S * 1e3
    bwd_bound, bwd_ops_bound = bwd_bytes / H100_BYTES_PER_S * 1e3, bwd_ops / H100_F32_OPS_PER_S * 1e3
    forward = {
        **common,
        "max_abs_err": max(fwd_errs),
        "out_ml_max_abs_err": fwd_errs,
        "tolerance": {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL},
        "ms": fwd_t,
        "ms_by_lanes": fwd_by_lanes,
        "plain_ms": fwd_plain,
        "replaced_ms": fwd_replaced,
        "replaced_note": "PyTorch gathers + per-head dot + masking around K2 (csr_softmax_spmm)",
        "library_ms": lib["library_ms"],
        "library_note": lib["library_note"],
        **{k_: v_ for k_, v_ in lib.items() if k_ not in ("library_ms", "library_note")},
        "bound_ms": max(fwd_bound, fwd_ops_bound),
        "bound_by": "bytes" if fwd_bound >= fwd_ops_bound else "operations",
        "bytes": fwd_bytes,
        "operations": fwd_ops,
    }
    lib_bwd = None if lib["library_ms"] is None else lib["library_fwd_bwd_ms"] - lib["library_ms"]
    backward = {
        **common,
        "max_abs_err": max(bwd_errs),
        "dq_dk_dv_max_abs_err": bwd_errs,
        "tolerance": {"rtol": K3_GRAD_RTOL, "atol": K3_GRAD_ATOL},
        "ms": bwd_t,
        "ms_by_lanes": bwd_by_lanes,
        "plain_ms": bwd_plain,
        "replaced_ms": (replaced_fb - fwd_replaced) if replaced else None,
        "replaced_note": ("autograd through the replaced forward (K3, the dot's backward, index_add_ "
                          "scatters) less that forward's time"),
        "library_ms": lib_bwd,
        "library_note": (lib["library_note"] if lib_bwd is None else
                         "SDPA forward+backward less its forward; " + lib["library_note"]),
        "bound_ms": max(bwd_bound, bwd_ops_bound),
        "bound_by": "bytes" if bwd_bound >= bwd_ops_bound else "operations",
        "bytes": bwd_bytes,
        "operations": bwd_ops,
    }
    return forward, backward


def build_epd(seed, device, dtype=None):
    from graphphysics_torch.core import NodeType
    from graphphysics_torch.models import (
        EncodeProcessDecode,
        Simulator,
        SimulatorConfig,
        reset_parameters,
    )

    cfg = SimulatorConfig(
        node_input_size=2 + int(NodeType.SIZE), edge_input_size=3, output_size=2,
        feature_index_start=0, feature_index_end=2,
        output_index_start=0, output_index_end=2, node_type_index=2,
    )
    model = EncodeProcessDecode(BLOCKS, cfg.node_input_size, 3, 2, HIDDEN, dtype=dtype)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return Simulator(cfg, model, device=device)


def build_transformer(param, seed, device):
    from graphphysics_torch.models import reset_parameters
    from graphphysics_torch.training import get_simulator

    sim = get_simulator(param, device="cpu")
    reset_parameters(sim.model, torch.Generator().manual_seed(seed))
    return sim.to(device)


def k1_geometries(reset=False) -> dict:
    """The f32 K1's launches by the geometry that ran
    (``csr_segment_sum.geometries``), read before ``reset`` sets them to 0."""
    from graphphysics_torch.ops.csr_segment import csr_segment_sum

    read = dict(csr_segment_sum.geometries)
    if reset:
        for kind in csr_segment_sum.geometries:
            csr_segment_sum.geometries[kind] = 0
    return read


def check_k1_words(name, result) -> None:
    """Every f32 K1 launch of a phase's counted run took the 16-byte
    words (the models' width, 128, on aligned messages)."""
    want = {"words16": result["launches"]["csr_segment_sum"], "columns": 0}
    if result["k1_f32_launches_by_geometry"] != want:
        raise AssertionError(f"{name}: f32 K1 launches by geometry {result['k1_f32_launches_by_geometry']}, "
                             f"expected {want}")


def serve(name, make_sim, frames, counts, expected, seed, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL):
    """Roll ``frames`` out on the card with a simulator from ``make_sim``:
    zero every launch count just before the rollout, check them just after
    against ``expected`` (kernel name -> launches), hold the first frames
    against the CPU (within ``rtol``, ``atol``), and time the eager and
    CUDA-graph forwards."""
    from graphphysics_torch.training import rollout, rollout_rmse

    sim = make_sim(seed, "cuda")
    frames_dev = frames.to("cuda")
    n_frames = frames_dev.x.shape[0]
    for t in range(n_frames):
        sim.accumulate_stats(frames_dev[t])
    rollout(sim, frames_dev[:2], device="cuda")  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    for fn in counts.values():
        fn.launches = 0
    k1_geometries(reset=True)
    t0 = time.perf_counter()
    preds, targets = rollout(sim, frames_dev, device="cuda")
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    by_geometry = k1_geometries()
    want = {k: expected.get(k, 0) * n_frames for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    out_width = sim.config.output_index_end - sim.config.output_index_start
    if preds.shape != (n_frames, frames.num_nodes, out_width) or not torch.isfinite(preds).all():
        raise AssertionError(f"{name}: bad predictions {tuple(preds.shape)}")

    sim_cpu = make_sim(seed, "cpu")
    sim_cpu.load_state_dict({k: v.cpu() for k, v in sim.state_dict().items()})
    preds_cpu, _ = rollout(sim_cpu, frames[:CPU_FRAMES], device="cpu")
    cpu_err = (preds[:CPU_FRAMES].cpu() - preds_cpu).abs().max().item()
    if not torch.allclose(preds[:CPU_FRAMES].cpu(), preds_cpu, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: GPU vs CPU rollout max_abs_err {cpu_err}")

    with torch.inference_mode():
        eager_forward = call_ms(lambda: sim(frames_dev[0]))
        graph_forward = device_ms(lambda g: sim(g), [(frames_dev[0],)], min_reps=5)
    rmse = rollout_rmse(preds, targets, frames_dev.node_mask[0]).item()
    profiled = 5
    breakdown = device_breakdown(lambda: rollout(sim, frames_dev[:profiled], device="cuda"), profiled)
    ms_per_frame = rollout_s / n_frames * 1e3
    result = {
        "frames": n_frames,
        "ms_per_frame": ms_per_frame,
        "rollout_s": rollout_s,
        "forward_eager_ms": eager_forward,
        "forward_cuda_graph_ms": graph_forward,
        "launches": launches,
        "k1_f32_launches_by_geometry": by_geometry,
        "rollout_rmse": rmse,
        "cpu_frames_checked": CPU_FRAMES,
        "cpu_max_abs_err": cpu_err,
        "cpu_rtol": rtol,
        "cpu_atol": atol,
    }
    profile_line = {
        "frames_profiled": profiled,
        "breakdown": breakdown if breakdown is not None else "not measured",
        "device_idle_share": (
            None if breakdown is None else 1.0 - breakdown["device_ms_per_frame"] / ms_per_frame
        ),
    }
    return sim, result, profile_line


def batched_forward(name, sim, batch, counts, expected):
    """One eval forward on a concatenated batch, launch counts checked."""
    for fn in counts.values():
        fn.launches = 0
    with torch.inference_mode():
        _, _, out = sim(batch)  # normalizer statistics from the trajectory
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: expected.get(k, 0) for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    width = sim.config.output_index_end - sim.config.output_index_start
    if out.shape != (batch.num_nodes, width) or not torch.isfinite(out).all():
        raise AssertionError(f"{name}: bad outputs {tuple(out.shape)}")
    with torch.inference_mode():
        forward_ms = call_ms(lambda: sim(batch), iters=10)
    return {
        "graphs": len(BATCH_NODES),
        "nodes": batch.num_nodes,
        "edges": batch.num_edges,
        "forward_ms": forward_ms,
        "launches": launches,
    }


def trajectory_frames(make_traj, frames, node_type_index, preprocessing, layout):
    """A synthetic trajectory on ``triangulated_grid(64, 32)`` (2,048 nodes,
    11,906 directed edges) as stacked frames, with the host's seconds."""
    from graphphysics_torch.core import round_up
    from graphphysics_torch.topology import face_to_edge
    from graphphysics_torch.training import stacked_trajectory

    traj, meta = make_traj(steps=frames + 1, nx=64, ny=32, phase0=0.0)
    n_real = traj["mesh_pos"].shape[1]
    e_real = len(face_to_edge(traj["cells"][0])[0])
    n_pad = round_up(n_real, 128)
    e_pad = round_up(int(e_real * 1.15), 128)
    t0 = time.perf_counter()
    stacked = stacked_trajectory(traj, meta, n_pad, e_pad, node_type_index=node_type_index,
                                 preprocessing=preprocessing, layout=layout)
    sizes = {"nodes": n_real, "edges": e_real, "n_pad": n_pad, "e_pad": e_pad,
             "host_frames_s": time.perf_counter() - t0}
    return stacked, sizes


def load_config(path, blocks=None):
    with open(path) as fp:
        param = json.load(fp)
    if blocks is not None:
        param["model"]["message_passing_num"] = blocks
    return param


def relu_sign_hooks(model, signs):
    """Forward hooks on every ``nn.ReLU`` of ``model`` that record which of
    its inputs are positive, packed to bits on the host, into the list
    ``signs`` in call order. Returns the hooks' handles."""

    def record(module, inputs, output):
        signs.append(np.packbits((inputs[0] > 0).cpu().numpy()))

    return [m.register_forward_hook(record) for m in model.modules()
            if isinstance(m, torch.nn.ReLU)]


def first_step(name, param, batch, seed, total_steps, grad_rtol, stats=None,
               loss_rtol=None, roundoff_share=None):
    """The first ``Trainer`` step on the card against the same step on the
    CPU from equal weights (seeded ``init_state``) and, where ``stats`` (a
    state dict of normalizer buffers) is given, equal normalizer
    statistics: the loss, and each parameter's gradient within
    ``grad_rtol``, with the worst one named. Beside them the number of ReLU
    inputs whose sign differs between the devices: an input within
    round-off of zero switches its unit's gradient on or off, which moves
    every gradient upstream of it without a fault in any kernel.
    ``loss_rtol`` and ``roundoff_share`` default to ``STEP_LOSS_RTOL`` and
    ``STEP_ROUNDOFF_SHARE`` (f32)."""
    from graphphysics_torch.training import Trainer

    loss_rtol = STEP_LOSS_RTOL if loss_rtol is None else loss_rtol
    roundoff_share = STEP_ROUNDOFF_SHARE if roundoff_share is None else roundoff_share
    loss, grads, signs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device=dev)
        trainer.init_state(total_steps)
        if stats is not None:
            trainer.sim.load_state_dict(stats, strict=False)
        signs[dev] = []
        hooks = relu_sign_hooks(trainer.sim, signs[dev])
        loss[dev] = trainer.train_step(batch).item()
        for hook in hooks:
            hook.remove()
        grads[dev] = {n: p.grad.detach().cpu() for n, p in trainer.sim.named_parameters()}
        del trainer
    relu_flips = sum(int(np.unpackbits(a ^ b).sum()) for a, b in zip(signs["cpu"], signs["cuda"]))
    loss_err = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    roundoff = [n for n in grads["cpu"] if n.endswith(ROUNDOFF_LEAVES)]
    rel = {n: ((grads["cuda"][n] - g).norm() / g.norm()).item()
           for n, g in grads["cpu"].items() if n not in roundoff}
    worst = max(rel, key=rel.get)
    share = 0.0
    for dev, gs in grads.items():
        top = max(g.abs().max().item() for n, g in gs.items() if n not in roundoff)
        share = max([share] + [gs[n].abs().max().item() / top for n in roundoff])
    result = {
        "first_step_cpu_loss": loss["cpu"],
        "first_step_card_loss": loss["cuda"],
        "first_step_loss_rel_err": loss_err,
        "first_step_grad_rel_err_worst": rel[worst],
        "first_step_grad_worst_param": worst,
        "first_step_grad_rel_err_median": float(np.median(list(rel.values()))),
        "first_step_params_compared": len(rel),
        "first_step_relu_inputs": sum(8 * len(a) for a in signs["cpu"]),
        "first_step_relu_sign_flips": relu_flips,
        "first_step_roundoff_params": len(roundoff),
        "first_step_roundoff_share": share,
        "first_step_tolerance": {"loss_rtol": loss_rtol, "grad_rtol_per_param": grad_rtol,
                                 "roundoff_share": roundoff_share},
    }
    if not (math.isfinite(loss["cuda"]) and loss_err <= loss_rtol
                      and rel[worst] <= grad_rtol and share <= roundoff_share):
        raise AssertionError(f"{name}: first step card vs CPU out of tolerance: {result}")
    return result


def fused_geometries(reset=False, bf16=False) -> dict:
    """The fused f32 forward's and backward's launches by the geometry that
    ran (``csr_attention.geometries``, ``csr_attention_backward.geometries``;
    with ``bf16`` the bf16 entries', ``csr_attention.bf16.geometries`` and
    ``csr_attention_backward.bf16.geometries``), read before ``reset`` sets
    them to 0."""
    from graphphysics_torch.ops.csr_attention import csr_attention, csr_attention_backward

    forward, backward = ((csr_attention.bf16, csr_attention_backward.bf16) if bf16
                         else (csr_attention, csr_attention_backward))
    read = {"forward": dict(forward.geometries), "backward": dict(backward.geometries)}
    if reset:
        for counter in (forward.geometries, backward.geometries):
            for kind in counter:
                counter[kind] = 0
    return read


def train(name, param, batch, counts, expected, seed, grad_rtol, graphs=len(BATCH_NODES),
          stats=None, check_batch=None, first=None, **limits):
    """``Trainer`` on one concatenated batch (of ``graphs`` graphs) on the
    card: the first step against the CPU (``first_step``, from the
    normalizer statistics ``stats`` where given; ``first``, a record of
    that check already made, stands for it), then on a fresh trainer
    3 warm-up steps and TIMED_STEPS timed ones with every launch count zeroed just
    before them and checked just after against ``expected`` (kernel name
    -> launches per step), then a profile of 3 steps. ``check_batch``
    (default ``batch``) is the first step's batch; ``limits`` reach
    ``first_step``."""
    from graphphysics_torch.training import Trainer

    total_steps = 1 + WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS
    if first is None:
        first = first_step(name, param, batch if check_batch is None else check_batch, seed, total_steps,
                           grad_rtol, stats=stats, **limits)

    trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda")
    trainer.init_state(total_steps)
    if stats is not None:
        trainer.sim.load_state_dict(stats, strict=False)
    dev_batch = batch.to("cuda")
    for _ in range(WARMUP_STEPS):
        trainer.train_step(dev_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counts.values():
        fn.launches = 0
    k1_geometries(reset=True)
    fused_geometries(reset=True)
    fused_geometries(reset=True, bf16=True)
    t0 = time.perf_counter()
    losses = [trainer.train_step(dev_batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    by_geometry = k1_geometries()
    fused_by_geometry = fused_geometries()
    fused_bf16_by_geometry = fused_geometries(bf16=True)
    want = {k: expected.get(k, 0) * TIMED_STEPS for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches} in {TIMED_STEPS} steps, expected {want}")
    losses = [x.item() for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    ms_per_step = seconds / TIMED_STEPS * 1e3
    breakdown = device_breakdown(
        lambda: [trainer.train_step(dev_batch) for _ in range(PROFILED_STEPS)], PROFILED_STEPS, unit="step"
    )
    real_edges = int(np.asarray(batch.edge_mask).sum())
    return {
        "graphs": graphs,
        "nodes": batch.num_nodes,
        "edges": batch.num_edges,
        "real_edges": real_edges,
        "ms_per_step": ms_per_step,
        "padded_edges_per_s": batch.num_edges / (ms_per_step / 1e3),
        "real_edges_per_s": real_edges / (ms_per_step / 1e3),
        "steps_timed": TIMED_STEPS,
        "launches": launches,
        "k1_f32_launches_by_geometry": by_geometry,
        "fused_f32_launches_by_geometry": fused_by_geometry,
        "fused_bf16_launches_by_geometry": fused_bf16_by_geometry,
        "launches_per_step": {k: v / TIMED_STEPS for k, v in launches.items()},
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "peak_memory_gb": peak_gb,
        **first,
        "profiled_steps": PROFILED_STEPS,
        "breakdown": breakdown if breakdown is not None else "not measured",
        "device_idle_share": (
            None if breakdown is None else 1.0 - breakdown["device_ms_per_step"] / ms_per_step
        ),
    }


def width_training(param, batch, frame, counts, blocks, seed, first, wide):
    """``train`` of the transformer at a width of the word geometry (its
    first step against the CPU given as ``first``), with every fused launch
    of its timed steps checked to have run the word geometry, the fused
    kernels' device ms a step from its profile, and an eager eval forward
    on a serving frame (its launches counted and checked the same way);
    beside it the 128 x 4 ``transformer_training`` record ``wide``."""
    expected = {"csr_attention": blocks, "csr_attention_backward": blocks}
    result = train("width_training", param, batch, counts, expected, seed, TRANSFORMER_GRAD_RTOL, first=first)
    words = {"forward": {"fast": 0, "words": blocks * TIMED_STEPS, "general": 0},
             "backward": {"fast": 0, "words": blocks * TIMED_STEPS, "general": 0}}
    if result["fused_f32_launches_by_geometry"] != words:
        raise AssertionError(f"width_training: fused launches by geometry "
                             f"{result['fused_f32_launches_by_geometry']}, expected {words}")
    breakdown = result["breakdown"]
    fused_ms = None
    if isinstance(breakdown, dict):
        groups = breakdown["by_category"]
        fused_ms = {k: groups.get(k, {}).get("ms_per_step", 0.0) for k in ("csr_attention", "csr_attention_bwd")}
    sim = build_transformer(param, seed, "cuda")
    dev_frame = frame.to("cuda")
    sim.accumulate_stats(dev_frame)
    with torch.inference_mode():
        sim(dev_frame)
        torch.cuda.synchronize()
        for fn in counts.values():
            fn.launches = 0
        fused_geometries(reset=True)
        _, _, out = sim(dev_frame)
        torch.cuda.synchronize()
        frame_launches = {k: fn.launches for k, fn in counts.items() if fn.launches}
        frame_geometries = fused_geometries()["forward"]
        forward_ms = call_ms(lambda: sim(dev_frame))
    if frame_launches != {"csr_attention": blocks} or frame_geometries["words"] != blocks:
        raise AssertionError(f"width_training: an eval forward launched {frame_launches}, by geometry "
                             f"{frame_geometries}; expected {blocks} word-geometry forwards")
    if out.shape[0] != frame.num_nodes or not torch.isfinite(out).all():
        raise AssertionError(f"width_training: bad eval outputs {tuple(out.shape)}")
    wide_breakdown = wide["breakdown"]
    return {
        **result,
        "fused_attention_device_ms_per_step": fused_ms,
        "eval_frame_nodes": frame.num_nodes,
        "forward_eager_ms": forward_ms,
        "eval_frame_launches": frame_launches,
        "eval_frame_launches_by_geometry": frame_geometries,
        "transformer_training_128x4": {
            "ms_per_step": wide["ms_per_step"],
            "device_ms_per_step": (wide_breakdown["device_ms_per_step"] if isinstance(wide_breakdown, dict)
                                   else None),
            "fused_attention_device_ms_per_step": (
                {k: wide_breakdown["by_category"].get(k, {}).get("ms_per_step", 0.0)
                 for k in ("csr_attention", "csr_attention_bwd")} if isinstance(wide_breakdown, dict) else None),
        },
        "shared_card": "the multi-rank phases run in a second process on the same card meanwhile",
    }


def bf16_width_training(param, batch, check_batch, frame, counts, blocks, seed, width_f32, wide_bf16):
    """``bf16_train`` of the transformer ``param`` (a width of the bf16 word
    geometry) on ``batch``, its first step against the CPU in bf16 on
    ``check_batch``, with every bf16 fused launch of its timed steps checked
    to have run the word geometry (``csr_attention.bf16.geometries``), one
    transposed CSR a step, the fused kernels' device ms a step from its
    profile, two steps replayed bit for bit (asserted: the backward has no
    atomics) and an eager eval forward on a serving frame (its launches
    counted and checked the same way); beside it the f32 transformer at the
    same width (``width_f32``, ``width_training``) and the bf16 one at 128 x
    4 (``wide_bf16``, ``bf16_transformer_training``)."""
    name = "bf16_width_training"
    expected = {"csr_attention_bf16": blocks, "csr_attention_backward_bf16": blocks, "gather_csr": 1}
    result = bf16_train(name, param, batch, check_batch, counts, expected, seed, width_f32)
    words = {"forward": {"fast": 0, "words": blocks * TIMED_STEPS, "general": 0},
             "backward": {"fast": 0, "words": blocks * TIMED_STEPS, "general": 0}}
    if result["fused_bf16_launches_by_geometry"] != words:
        raise AssertionError(f"{name}: bf16 fused launches by geometry "
                             f"{result['fused_bf16_launches_by_geometry']}, expected {words}")
    replay = replay_bitwise(with_precision(param, "bf16"), batch, seed)
    if not replay["bitwise"]:
        raise AssertionError(f"{name}: two bf16 steps from one seeded state differ: {replay}")

    def fused_ms(breakdown):
        if not isinstance(breakdown, dict):
            return None
        groups = breakdown["by_category"]
        return {k: groups.get(k, {}).get("ms_per_step", 0.0) for k in ("csr_attention", "csr_attention_bwd")}

    sim = build_transformer(with_precision(param, "bf16"), seed, "cuda")
    dev_frame = frame.to("cuda")
    sim.accumulate_stats(dev_frame)
    with torch.inference_mode():
        sim(dev_frame)
        torch.cuda.synchronize()
        for fn in counts.values():
            fn.launches = 0
        fused_geometries(reset=True, bf16=True)
        _, _, out = sim(dev_frame)
        torch.cuda.synchronize()
        frame_launches = {k: fn.launches for k, fn in counts.items() if fn.launches}
        frame_geometries = fused_geometries(bf16=True)["forward"]
        forward_ms = call_ms(lambda: sim(dev_frame))
    if frame_launches != {"csr_attention_bf16": blocks} or frame_geometries["words"] != blocks:
        raise AssertionError(f"{name}: an eval forward launched {frame_launches}, by geometry "
                             f"{frame_geometries}; expected {blocks} word-geometry bf16 forwards")
    if out.shape[0] != frame.num_nodes or not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: bad eval outputs {tuple(out.shape)}")
    wide_breakdown = wide_bf16["breakdown"]
    return {
        **result,
        "fused_attention_device_ms_per_step": fused_ms(result["breakdown"]),
        "replay": replay,
        "eval_frame_nodes": frame.num_nodes,
        "forward_eager_ms": forward_ms,
        "eval_frame_launches": frame_launches,
        "eval_frame_launches_by_geometry": frame_geometries,
        "bf16_transformer_training_128x4": {
            "ms_per_step": wide_bf16["ms_per_step"],
            "device_ms_per_step": (wide_breakdown["device_ms_per_step"] if isinstance(wide_breakdown, dict)
                                   else None),
            "fused_attention_device_ms_per_step": fused_ms(wide_breakdown)},
        "f32_width_training_fused_attention_device_ms_per_step": width_f32.get(
            "fused_attention_device_ms_per_step"),
        "shared_card": "the multi-rank phases run in a second process on the same card meanwhile",
    }


def memory_datasets(param, make_traj, seed, directory, n_traj):
    """Training and validation ``MemoryDataset``s over ``n_traj`` synthetic
    trajectories on ``triangulated_grid(64, 32)`` (2,048 nodes, 8 frames
    each) held in memory, with the config's training preprocessing (noise
    included) and its validation one; the meta file goes to ``directory``."""
    import chip_fidelity
    from graphphysics_torch.utils.synthetic import write_json

    trajs = [make_traj(steps=9, nx=64, ny=32, phase0=0.15 * k)[0] for k in range(n_traj)]
    meta_path = write_json(f"{directory}/meta.json", make_traj(steps=9, nx=2, ny=2)[1])
    return (chip_fidelity.memory_split(param, trajs, meta_path, val=False, seed=seed),
            chip_fidelity.memory_split(param, trajs, meta_path, val=True, seed=seed))


def pipeline(name, param, make_traj, counts, expected, seed):
    """Two synthetic trajectories (``memory_datasets``) through
    ``GraphLoader`` batches of 8 frames and ``Trainer.fit`` for 2 epochs
    with rollout validation on the card. ``expected`` gives (launches per
    step, launches per validated frame)."""
    import tempfile

    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = memory_datasets(param, make_traj, seed, tmp, n_traj=2)
        loader = GraphLoader(train_ds, batch_size=8, shuffle=True, seed=seed)
        trainer = Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda",
                          checkpoint_dir=tmp, metrics_path=None, rollout_dir=None)
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        history = trainer.fit(loader, val_dataset=val_ds, num_epochs=2, val_trajectories=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    steps = 2 * len(loader)
    frames = 2 * train_ds.frames_per_trajectory
    want = {k: expected.get(k, (0, 0))[0] * steps + expected.get(k, (0, 0))[1] * frames
            for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    values = history["train_loss"] + history["val_rmse"]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{name}: non-finite history {history}")
    batch = loader.peek()
    return {
        "dataset_items": len(train_ds),
        "batch_nodes": batch.num_nodes,
        "batch_edges": batch.num_edges,
        "node_budget": train_ds.node_budget,
        "edge_budget": train_ds.edge_budget,
        "steps": steps,
        "validated_frames": frames,
        "train_loss": history["train_loss"],
        "val_rmse": history["val_rmse"],
        "launches": launches,
        "fit_s": seconds,
    }


def sampler_statistics(seed):
    """The card's GMM sampler over ``GMM_SAMPLER_DRAWS`` draws of one fixed
    diagonal mixture (K = 3, d = 3) with a CUDA generator: the component
    frequencies against softmax(logits), and each component's mean and std
    against its own, in standard errors; the worst must lie within
    ``GMM_SIGMAS``. The component ids come from the same draws
    (``draw_gmm`` on a generator of the same seed)."""
    from graphphysics_torch.models.gmm import components, draw_gmm, sample_gmm_diagonal

    dev = torch.device("cuda")
    n, K, d = GMM_SAMPLER_DRAWS, 3, 3
    logits = torch.tensor([0.3, -0.4, 1.1], device=dev)
    means = torch.tensor([[-3.0, 1.0, 0.5], [0.0, 4.0, -1.0], [3.0, -2.0, 2.0]], device=dev)
    stds = torch.tensor([[0.5, 1.0, 0.2], [0.3, 0.2, 2.0], [1.5, 0.7, 0.4]], device=dev)
    row = torch.cat([logits[:, None], means, stds.log()], dim=1).reshape(1, -1)
    net = row.expand(n, -1).contiguous()
    gumbel, _ = draw_gmm(n, K, d, torch.Generator(device=dev).manual_seed(seed))
    ids = components(logits.expand(n, K), gumbel)
    out = sample_gmm_diagonal(net, d, K, 1.0, torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    if out.device.type != "cuda" or not torch.isfinite(out).all():
        raise AssertionError("card sampler: output not finite on the card")
    alpha = torch.softmax(logits.double(), 0)
    freq = torch.bincount(ids, minlength=K).double() / n
    freq_sigma = ((freq - alpha).abs() / (alpha * (1 - alpha) / n).sqrt()).tolist()
    mean_sigma, std_sigma = [], []
    for k in range(K):
        rows = out[ids == k].double()
        m = rows.shape[0]
        sd = stds[k].double()
        mean_sigma.append(((rows.mean(0) - means[k]).abs() / (sd / math.sqrt(m))).max().item())
        std_sigma.append(((rows.std(0) - sd).abs() / (sd / math.sqrt(2 * m))).max().item())
    worst = max(freq_sigma + mean_sigma + std_sigma)
    result = {"draws": n, "components": K, "d": d, "frequencies": freq.tolist(),
              "mixture_weights": alpha.tolist(), "frequency_sigmas": freq_sigma,
              "mean_sigmas_worst_dim": mean_sigma, "std_sigmas_worst_dim": std_sigma,
              "worst_sigmas": worst, "limit_sigmas": GMM_SIGMAS}
    if not worst <= GMM_SIGMAS:
        raise AssertionError(f"card sampler statistics off: {result}")
    return result


def shared_draws(name, param, sim, frames, seed, previous=None):
    """The first ``CPU_FRAMES`` frames of the sampled rollout on the card
    against the CPU's, both drawing from a CPU generator of one seed, on
    the real nodes. Each node draws its component as the best of its
    (logit + Gumbel) scores; where the two best lie closer on the CPU than
    the card's logits differ from the CPU's, the card may choose another
    component. So for each seed tried, each checked frame's input of the CPU
    rollout is run on both devices (the logits' largest difference, d) and
    the generator's draws replayed (the smallest gap of a sampled node: real
    and not clamped to its target); a seed is taken once that gap is at
    least ``GMM_TIE_FACTOR`` times d, and seeds are tried in turn.
    ``previous`` (the rollout's previous-data options) feeds the
    previous-data slice too."""
    from graphphysics_torch.models.gmm import draw_gmm
    from graphphysics_torch.training import build_mask, rollout

    previous = previous or {}
    cfg = sim.config
    os_, oe = cfg.output_index_start, cfg.output_index_end
    K, d = sim.model.K, sim.model.d
    sim_cpu = build_transformer(param, seed, "cpu")
    sim_cpu.load_state_dict({k: v.cpu() for k, v in sim.state_dict().items()})
    host = frames[:CPU_FRAMES].to("cpu")
    real = host.node_mask[0].bool()
    sampled = real & ~build_mask(host.x[0, :, cfg.node_type_index].long())
    n = host.x.shape[1]

    def logits(model, g):
        with torch.inference_mode():
            out = model(g, generator=torch.Generator().manual_seed(0))[0]
        return out.reshape(n, K, -1)[..., 0].cpu()

    tries = []
    for attempt in range(GMM_SEED_TRIES):
        draw_seed = seed + 1000 + attempt
        cpu_preds, _ = rollout(sim_cpu, host, device="cpu",
                               generator=torch.Generator().manual_seed(draw_seed), **previous)
        draws = torch.Generator().manual_seed(draw_seed)
        gap, logit_diff, fed = math.inf, 0.0, None
        for t in range(CPU_FRAMES):
            g = host[t]
            if t:
                x = g.x.clone()
                x[:, os_:oe] = cpu_preds[t - 1]
                if previous:
                    x[:, previous["previous_data_start"]:previous["previous_data_end"]] = \
                        cpu_preds[t - 1] - fed
                g = g.replace(x=x)
            fed = g.x[:, os_:oe]
            cpu_logits = logits(sim_cpu, g)
            logit_diff = max(logit_diff, (logits(sim, g.to("cuda")) - cpu_logits).abs().max().item())
            gumbel, _ = draw_gmm(n, K, d, draws)
            top = (cpu_logits + gumbel).topk(2, dim=-1).values
            gap = min(gap, (top[:, 0] - top[:, 1])[sampled].min().item())
        tries.append({"seed": draw_seed, "min_gap": gap, "logit_max_abs_diff": logit_diff})
        if gap >= GMM_TIE_FACTOR * logit_diff:
            break
    else:
        raise AssertionError(f"{name}: every seed tried has a near tie: {tries}")
    card_preds, _ = rollout(sim, host.to("cuda"), device="cuda",
                            generator=torch.Generator().manual_seed(draw_seed), **previous)
    got, want = card_preds.cpu()[:, real], cpu_preds[:, real]
    err = (got - want).abs().max().item()
    result = {"shared_draw_frames": CPU_FRAMES, "shared_draw_seed_tries": tries,
              "shared_draw_max_abs_err": err, "cpu_rtol": ROLLOUT_RTOL, "cpu_atol": ROLLOUT_ATOL,
              "tie_factor": GMM_TIE_FACTOR}
    if not torch.allclose(got, want, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL):
        raise AssertionError(f"{name}: card vs CPU sampled rollout under shared draws: {result}")
    return result


def gmm_serving(name, param, frames, counts, seed):
    """A sampled rollout of ``frames`` on the card by the GMM transformer of
    ``param`` (random weights from the seed, statistics from the frames),
    drawing from a CUDA generator: launches checked (one fused forward per
    block and frame), the same rollout again from an equal seed bitwise
    equal, then ``shared_draws`` against the CPU, ``sampler_statistics`` and
    a profile of 5 frames."""
    from graphphysics_torch.training import rollout, rollout_rmse

    blocks = param["model"]["message_passing_num"]
    sim = build_transformer(param, seed, "cuda")
    frames_dev = frames.to("cuda")
    n_frames = frames_dev.x.shape[0]
    for t in range(n_frames):
        sim.accumulate_stats(frames_dev[t])

    def generator():
        return torch.Generator(device="cuda").manual_seed(seed)

    rollout(sim, frames_dev[:2], device="cuda", generator=generator())  # warm-up
    torch.cuda.synchronize()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    preds, targets = rollout(sim, frames_dev, device="cuda", generator=generator())
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: (blocks * n_frames if k == "csr_attention" else 0) for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    out_width = sim.config.output_index_end - sim.config.output_index_start
    if preds.shape != (n_frames, frames.num_nodes, out_width) or not torch.isfinite(preds).all():
        raise AssertionError(f"{name}: bad predictions {tuple(preds.shape)}")
    again, _ = rollout(sim, frames_dev, device="cuda", generator=generator())
    if not torch.equal(again, preds):
        raise AssertionError(f"{name}: two rollouts of one generator seed differ by "
                             f"{(again - preds).abs().max().item()}")
    other, _ = rollout(sim, frames_dev[:2], device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    if torch.equal(other, preds[:2]):
        raise AssertionError(f"{name}: another generator seed gave the same frames")
    shared = shared_draws(name, param, sim, frames, seed)
    stats = sampler_statistics(seed)
    rmse = rollout_rmse(preds, targets, frames_dev.node_mask[0]).item()
    profiled = 5
    breakdown = device_breakdown(
        lambda: rollout(sim, frames_dev[:profiled], device="cuda", generator=generator()), profiled)
    ms_per_frame = rollout_s / n_frames * 1e3
    return {
        "frames": n_frames,
        "nodes": frames.num_nodes,
        "edges": frames.num_edges,
        "real_edges": int(np.asarray(frames.edge_mask[0]).sum()),
        "output_width": out_width,
        "ms_per_frame": ms_per_frame,
        "rollout_s": rollout_s,
        "launches": launches,
        "launches_per_frame": {k: v / n_frames for k, v in launches.items()},
        "repeat_bitwise_equal": True,
        "rollout_rmse": rmse,
        **shared,
        "sampler_statistics": stats,
        "frames_profiled": profiled,
        "breakdown": breakdown if breakdown is not None else "not measured",
        "device_idle_share": (
            None if breakdown is None else 1.0 - breakdown["device_ms_per_frame"] / ms_per_frame
        ),
    }


def gmm_pipeline(name, param, make_traj, counts, seed):
    """A GMM head through the training pipeline on the card: two synthetic
    trajectories (``memory_datasets``) through ``GraphLoader`` batches of 8
    frames and ``Trainer.fit`` for 2 epochs with sampled rollout validation
    (``val_loss`` None), the checkpoint reloaded into a fresh ``Trainer``
    and ``predict`` run twice from it: bitwise equal frames (the draws come
    from ``(seed, trajectory)``). Launches checked on each."""
    import tempfile

    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer, load_checkpoint

    blocks = param["model"]["message_passing_num"]
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = memory_datasets(param, make_traj, seed, tmp, n_traj=2)
        loader = GraphLoader(train_ds, batch_size=8, shuffle=True, seed=seed)
        trainer = Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda",
                          checkpoint_dir=tmp, metrics_path=None, rollout_dir=None)
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        history = trainer.fit(loader, val_dataset=val_ds, num_epochs=2, val_trajectories=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        steps = 2 * len(loader)
        frames = 2 * val_ds.frames_per_trajectory
        want = {k: 0 for k in counts}
        want["csr_attention"] = blocks * (steps + frames)
        want["csr_attention_backward"] = blocks * steps
        if launches != want:
            raise AssertionError(f"{name}: fit launches {launches}, expected {want}")
        values = history["train_loss"] + history["val_rmse"]
        if not all(math.isfinite(v) for v in values) or trainer.last_val_loss is not None:
            raise AssertionError(f"{name}: history {history}, val_loss {trainer.last_val_loss}")
        fresh = Trainer(param, seed=seed + 1, device="cuda", metrics_path=None, rollout_dir=None)
        fresh.init_state(1)
        load_checkpoint(f"{tmp}/state.pt", fresh)
        for fn in counts.values():
            fn.launches = 0
        first = fresh.predict(val_ds, save_dir=None, max_trajectories=1)[0]
        second = fresh.predict(val_ds, save_dir=None, max_trajectories=1)[0]
        predict_launches = {k: fn.launches for k, fn in counts.items()}
    n_frames = val_ds.frames_per_trajectory
    want = {k: (2 * blocks * n_frames if k == "csr_attention" else 0) for k in counts}
    if predict_launches != want:
        raise AssertionError(f"{name}: predict launches {predict_launches}, expected {want}")
    if not (np.isfinite(first).all() and np.array_equal(first, second)):
        raise AssertionError(f"{name}: predict from the reloaded checkpoint does not repeat: "
                             f"{np.abs(first - second).max()}")
    return {
        "dataset_items": len(train_ds),
        "steps": steps,
        "validated_frames": frames,
        "train_loss": history["train_loss"],
        "val_rmse": history["val_rmse"],
        "val_loss": trainer.last_val_loss,
        "launches": launches,
        "predict_frames": n_frames,
        "predict_launches_two_runs": predict_launches,
        "predict_repeat_bitwise_equal": True,
        "fit_s": fit_s,
    }


def aneurysm_folders(directory, grid):
    """The aneurysm XDMF folders of ``aneurysm_xdmf_pipeline`` under
    ``directory``, heavy data inline (``chip_fidelity.write_aneurysm_inline``):
    ``ANEURYSM_TRAJECTORIES`` training trajectories (seed 0) and
    ``ANEURYSM_HELD_OUT`` held-out ones (seed 12345) on ``tet_grid(grid)``.
    Returns ((train, held-out, meta path), seconds)."""
    import chip_fidelity

    t0 = time.perf_counter()
    train_dir, meta_path = chip_fidelity.write_aneurysm_inline(
        f"{directory}/train", ANEURYSM_TRAJECTORIES, ANEURYSM_FRAMES, grid, seed=0)
    held_out, _ = chip_fidelity.write_aneurysm_inline(
        f"{directory}/held_out", ANEURYSM_HELD_OUT, ANEURYSM_FRAMES, grid, seed=12345)
    return (train_dir, held_out, meta_path), time.perf_counter() - t0


def rollout_against_cpu(name, param, sim, frames, seed, previous=None):
    """The first ``CPU_FRAMES`` frames of the rollout on the card against
    the CPU (equal weights), on the real nodes. With ``previous`` (the
    previous-data options) the slice is fed back, and the card's rollout
    without the feeding must differ, so the slice was fed."""
    from graphphysics_torch.training import rollout

    previous = previous or {}
    sim_cpu = build_transformer(param, seed, "cpu")
    sim_cpu.load_state_dict({k: v.cpu() for k, v in sim.state_dict().items()})
    host = frames[:CPU_FRAMES].to("cpu")
    real = host.node_mask[0].bool()
    want, _ = rollout(sim_cpu, host, device="cpu", **previous)
    got, _ = rollout(sim, host.to("cuda"), device="cuda", **previous)
    got, want = got.cpu()[:, real], want[:, real]
    err = (got - want).abs().max().item()
    result = {"cpu_frames_checked": CPU_FRAMES, "cpu_max_abs_err": err, "cpu_rtol": ROLLOUT_RTOL,
              "cpu_atol": ROLLOUT_ATOL}
    if not torch.allclose(got, want, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL):
        raise AssertionError(f"{name}: card vs CPU rollout: {result}")
    if previous:
        unfed, _ = rollout(sim, host.to("cuda"), device="cuda")
        result["previous_data_feedback_max_abs_effect"] = (got - unfed.cpu()[:, real]).abs().max().item()
        if not result["previous_data_feedback_max_abs_effect"] > ROLLOUT_ATOL:
            raise AssertionError(f"{name}: the previous-data slice changed nothing: {result}")
    return result


def aneurysm_pipeline(name, param, folders, counts, seed):
    """An aneurysm config through the XDMF path on the card: ``get_dataset``
    over the inline-XML folders (previous data, the aneurysm features, CSR
    layout), both splits padded alike; the XDMF read and the preprocessing
    of ``HOST_SAMPLES`` items timed apart; ``Trainer.fit`` for one epoch
    with rollout validation; ``train`` on the loader's first batch (the
    first step against the CPU from the epoch's normalizer statistics,
    timed steps, launches, profile); the checkpoint reloaded into a fresh
    ``Trainer`` and ``predict`` over the held-out trajectory; its first
    frames against the CPU (the GMM head under shared draws). Launch counts
    are zeroed before and checked after each of fit, the timed steps and
    predict."""
    import tempfile

    import chip_fidelity
    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.external import build_features
    from graphphysics_torch.training import (
        Trainer,
        get_dataset,
        get_preprocessing,
        load_checkpoint,
        rollout,
    )

    train_dir, held_out, meta_path = folders
    blocks = param["model"]["message_passing_num"]
    K = int(param["model"].get("num_mixture_components", 0))
    param = json.loads(json.dumps(param))
    param["dataset"].update(xdmf_folder=train_dir, meta_path=meta_path)
    val_param = json.loads(json.dumps(param))
    val_param["dataset"]["xdmf_folder"] = held_out

    def dataset(p, val):
        pre = get_preprocessing(p, use_edge_feature=False, remove_noise=val,
                                extra_node_features=build_features)
        return get_dataset(p, pre, use_edge_feature=False, use_previous_data=True, seed=seed)

    train_ds, val_ds = dataset(param, False), dataset(val_param, True)
    t0 = time.perf_counter()
    chip_fidelity.unify_budgets(train_ds, val_ds)
    budgets_s = time.perf_counter() - t0
    read_s, pre_s = [], []
    for i in range(HOST_SAMPLES):
        t0 = time.perf_counter()
        raw = train_ds._load(i)
        t1 = time.perf_counter()
        train_ds.preprocessing(raw, np.random.default_rng(i))
        read_s.append(t1 - t0)
        pre_s.append(time.perf_counter() - t1)
    loader = GraphLoader(train_ds, batch_size=1, shuffle=True, seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda",
                          checkpoint_dir=tmp, metrics_path=None, rollout_dir=None,
                          **ANEURYSM_PREVIOUS)
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        history = trainer.fit(loader, val_dataset=val_ds, num_epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = {k: fn.launches for k, fn in counts.items()}
        fit_steps = len(loader)
        frames = val_ds.size_dataset * val_ds.frames_per_trajectory
        want = {k: 0 for k in counts}
        want["csr_attention"] = blocks * (fit_steps + frames)
        want["csr_attention_backward"] = blocks * fit_steps
        if fit_launches != want:
            raise AssertionError(f"{name}: fit launches {fit_launches}, expected {want}")
        values = history["train_loss"] + history["val_rmse"]
        val_loss_ok = (trainer.last_val_loss is None) if K else math.isfinite(trainer.last_val_loss)
        if not all(math.isfinite(v) for v in values) or not val_loss_ok:
            raise AssertionError(f"{name}: history {history}, val_loss {trainer.last_val_loss}")
        fresh = Trainer(param, seed=seed + 1, device="cuda", metrics_path=None, rollout_dir=None,
                        **ANEURYSM_PREVIOUS)
        fresh.init_state(1)
        load_checkpoint(f"{tmp}/state.pt", fresh)

    # a batch of one frame holds the time and the inflow statistics (x
    # columns 4 and 11-13) constant: the normalizer's f32 variance of such a
    # column, E[x^2] - E[x]^2, is round-off, and the normalized column
    # differs from device to device (ROADMAP, faults of the port). The
    # compared step starts from the statistics the epoch above accumulated
    # over every training item, copied to both devices.
    stats = {k: v.cpu() for k, v in trainer.sim.state_dict().items() if "_normalizer." in k}
    batch = loader.peek()
    steps = train(name, param, batch, counts,
                  {"csr_attention": blocks, "csr_attention_backward": blocks}, seed,
                  TRANSFORMER_GRAD_RTOL, graphs=1, stats=stats)

    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    preds = fresh.predict(val_ds, save_dir=None)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    predict_launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: (blocks * frames if k == "csr_attention" else 0) for k in counts}
    if predict_launches != want:
        raise AssertionError(f"{name}: predict launches {predict_launches}, expected {want}")
    shape = (val_ds.frames_per_trajectory, val_ds.node_budget, 3)
    if not all(p.shape == shape and np.isfinite(p).all() for p in preds):
        raise AssertionError(f"{name}: predictions {[p.shape for p in preds]}, expected {shape}")

    held = stack_graphs([val_ds[i] for i in val_ds.trajectory_indices(0)])
    held_dev = held.to("cuda")
    generator = torch.Generator(device="cuda").manual_seed(seed) if K else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rollout(fresh.sim, held_dev, device="cuda", generator=generator, **ANEURYSM_PREVIOUS)
    torch.cuda.synchronize()
    rollout_ms_per_frame = (time.perf_counter() - t0) / held.x.shape[0] * 1e3
    if K:
        cpu_check = shared_draws(name, param, fresh.sim, held, seed, previous=ANEURYSM_PREVIOUS)
    else:
        cpu_check = rollout_against_cpu(name, param, fresh.sim, held, seed, previous=ANEURYSM_PREVIOUS)
    launches = {k: steps["launches"][k] + fit_launches[k] + predict_launches[k] for k in counts}
    return {
        "nodes": int(batch.node_mask.sum()),
        "real_edges": steps["real_edges"],
        "node_budget": train_ds.node_budget,
        "edge_budget": train_ds.edge_budget,
        "train_items": len(train_ds),
        "held_out_frames": frames,
        "budgets_s": budgets_s,
        "host_read_ms_per_sample": float(np.mean(read_s)) * 1e3,
        "host_preprocessing_ms_per_sample": float(np.mean(pre_s)) * 1e3,
        "host_samples_timed": HOST_SAMPLES,
        **{f"step_{k}": v for k, v in steps.items() if k not in ("graphs", "launches")},
        "step_launches": steps["launches"],
        "first_step_statistics": f"the {len(train_ds)} training items of the fit's epoch",
        "fit_steps": fit_steps,
        "fit_s": fit_s,
        "fit_launches": fit_launches,
        "train_loss": history["train_loss"],
        "val_rmse": history["val_rmse"],
        "val_loss": trainer.last_val_loss,
        "predict_frames": frames,
        "predict_ms_per_frame": predict_s / frames * 1e3,
        "predict_launches": predict_launches,
        "rollout_ms_per_frame": rollout_ms_per_frame,
        **cpu_check,
        "launches": launches,
    }


def plate_pipeline(name, param, counts, seed, workers):
    """``param`` (``plate.json``) on the card, from in-memory press
    trajectories: the host's time per sample; the world edges of each
    frame; ``Trainer.fit`` for one epoch with rollout validation from an
    in-process loader and again from a loader of ``workers`` processes, the
    batches of both bit-equal, the first under the profiler for the card's
    idle share; the started workers' items per second over the next epoch;
    ``train``
    on the first batch (the first step against the CPU from the first fit's
    normalizer statistics, timed steps, launches, profile); ``predict``
    over the held-out trajectory from the reloaded checkpoint and its first
    frames against the CPU. Launch counts are zeroed before and checked
    after each fit, the timed steps and predict."""
    import tempfile

    import chip_fidelity
    from graphphysics_torch.core import NodeType, stack_graphs
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.topology import world_edges
    from graphphysics_torch.training import Trainer, load_checkpoint
    from graphphysics_torch.utils import synthetic

    blocks = param["model"]["message_passing_num"]
    wpp = param["transformations"]["world_pos_parameters"]
    radius = wpp.get("radius", 0.03)
    wps, wpe = wpp["world_pos_index_start"], wpp["world_pos_index_end"]
    # the node type's column before add_obstacles_next_pos inserts its 3
    node_type_raw = param["index"]["node_type_index"] - (wpe - wps)
    nx, nz = PLATE_GRID

    def trajectories(n, traj_seed):
        return [synthetic.plate_press_trajectory(PLATE_FRAMES, nx, nz, *c)[0]
                for c in synthetic.plate_press_conditions(n, traj_seed)]

    t0 = time.perf_counter()
    train_trajs, held_trajs = trajectories(PLATE_TRAJECTORIES, 0), trajectories(PLATE_HELD_OUT, 12345)
    data_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        meta_path = synthetic.write_json(f"{tmp}/meta.json", synthetic.plate_press_meta(PLATE_FRAMES))
        train_ds = chip_fidelity.memory_split(param, train_trajs, meta_path, val=False, seed=seed)
        val_ds = chip_fidelity.memory_split(param, held_trajs, meta_path, val=True, seed=seed)
        t0 = time.perf_counter()
        chip_fidelity.unify_budgets(train_ds, val_ds)
        budgets_s = time.perf_counter() - t0

        # the host's work per sample, step by step
        host = {"load": [], "world_edges": [], "rest_of_preprocessing": [], "pad": []}
        for i in range(HOST_SAMPLES):
            rng = np.random.default_rng(i)
            t0 = time.perf_counter()
            raw = train_ds._load(i)
            host["load"].append(time.perf_counter() - t0)
            spent = {"world_edges": 0.0, "rest_of_preprocessing": 0.0}
            for step in train_ds.preprocessing.steps:
                t0 = time.perf_counter()
                raw = step(raw, rng)
                world = getattr(step, "func", step).__name__ == "add_world_edges"
                spent["world_edges" if world else "rest_of_preprocessing"] += time.perf_counter() - t0
            for k, v in spent.items():
                host[k].append(v)
            raw.edge_attr = None  # the model takes no edge features
            t0 = time.perf_counter()
            train_ds._pad(raw)
            host["pad"].append(time.perf_counter() - t0)
        host_ms = {f"host_{k}_ms_per_sample": float(np.mean(v)) * 1e3 for k, v in host.items()}

        # the world edges of each frame of the first training trajectory
        per_frame = []
        for i in train_ds.trajectory_indices(0):
            x = train_ds._load(i).x
            ws, _ = world_edges(x[:, wps:wpe], x[:, node_type_raw], radius,
                                int(NodeType.OBSTACLE), int(NodeType.NORMAL))
            per_frame.append(2 * len(ws))  # both directions
        if not per_frame[-1] > 0:
            raise AssertionError(f"{name}: no world edges on the contact frame: {per_frame}")

        steps_per_epoch = len(train_ds)
        frames = val_ds.size_dataset * val_ds.frames_per_trajectory
        fits = {}
        loaders = {
            "in_process": GraphLoader(train_ds, batch_size=1, shuffle=True, seed=seed, prefetch=0),
            "workers": GraphLoader(train_ds, batch_size=1, shuffle=True, seed=seed, prefetch=2,
                                   num_workers=workers),
        }
        try:
            for tag, loader in loaders.items():
                trainer = Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda",
                                  checkpoint_dir=f"{tmp}/{tag}", metrics_path=None,
                                  rollout_dir=None)
                recorder = RecordingLoader(loader)
                history, span = [], []

                def fit():
                    span.append(time.perf_counter())
                    history.append(trainer.fit(recorder, val_dataset=val_ds, num_epochs=1))
                    torch.cuda.synchronize()
                    span.append(time.perf_counter())

                for fn in counts.values():
                    fn.launches = 0
                torch.cuda.synchronize()
                # the card runs the same kernels in both fits: one trace
                # gives the epoch's device time
                if tag == "in_process":
                    breakdown = device_breakdown(fit, 1, unit="epoch")
                    device_ms_epoch = None if breakdown is None else breakdown["device_ms_per_epoch"]
                else:
                    fit()
                fit_s = span[1] - span[0]
                launches = {k: fn.launches for k, fn in counts.items()}
                want = {k: 0 for k in counts}
                want["csr_attention"] = blocks * (steps_per_epoch + frames)
                want["csr_attention_backward"] = blocks * steps_per_epoch
                if launches != want:
                    raise AssertionError(f"{name} ({tag}): fit launches {launches}, expected {want}")
                values = history[0]["train_loss"] + history[0]["val_rmse"]
                if not all(math.isfinite(v) for v in values):
                    raise AssertionError(f"{name} ({tag}): history {history[0]}")
                fits[tag] = {
                    "trainer": trainer, "digests": recorder.digests, "launches": launches,
                    "fit_s": fit_s, "first_batch_s": recorder.times[0] - span[0],
                    "items_per_s": steps_per_epoch / fit_s,
                    "device_ms": device_ms_epoch,
                    "device_idle_share": (None if device_ms_epoch is None
                                          else 1.0 - device_ms_epoch / (fit_s * 1e3)),
                    "train_loss": history[0]["train_loss"], "val_rmse": history[0]["val_rmse"],
                }
            if fits["workers"]["digests"] != fits["in_process"]["digests"]:
                raise AssertionError(f"{name}: the workers' batches differ from the in-process ones")
            # the workers alone over the next epoch, started: their items per
            # second against the host's one sample at a time
            workers_loader = loaders["workers"]
            workers_loader.set_epoch(1)
            t0 = time.perf_counter()
            passed = sum(1 for _ in workers_loader)
            workers_items_per_s = passed / (time.perf_counter() - t0)
        finally:
            loaders["workers"].close()

        trainer = fits["in_process"]["trainer"]
        # the step's batch: the first of the fit's epoch (the workers' pass
        # moved the shared dataset to epoch 1)
        loaders["in_process"].set_epoch(0)
        # equal normalizer statistics on both devices for the first step:
        # a frame's obstacle displacement (x columns 3:6) is one value over
        # its nodes, whose f32 variance from one frame would be round-off
        # (ROADMAP, faults of the port); the fit accumulated every item
        stats = {k: v.cpu() for k, v in trainer.sim.state_dict().items() if "_normalizer." in k}
        batch = loaders["in_process"].peek()
        steps = train(name, param, batch, counts,
                      {"csr_attention": blocks, "csr_attention_backward": blocks}, seed,
                      TRANSFORMER_GRAD_RTOL, graphs=1, stats=stats)

        fresh = Trainer(param, seed=seed + 1, device="cuda", metrics_path=None, rollout_dir=None)
        fresh.init_state(1)
        load_checkpoint(f"{tmp}/in_process/state.pt", fresh)
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    preds = fresh.predict(val_ds, save_dir=None)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    predict_launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: (blocks * frames if k == "csr_attention" else 0) for k in counts}
    if predict_launches != want:
        raise AssertionError(f"{name}: predict launches {predict_launches}, expected {want}")
    shape = (val_ds.frames_per_trajectory, val_ds.node_budget, 3)
    if not all(p.shape == shape and np.isfinite(p).all() for p in preds):
        raise AssertionError(f"{name}: predictions {[p.shape for p in preds]}, expected {shape}")
    held = stack_graphs([val_ds[i] for i in val_ds.trajectory_indices(0)[:CPU_FRAMES]])
    cpu_check = rollout_against_cpu(name, param, fresh.sim, held, seed)

    launches = {k: steps["launches"][k] + predict_launches[k]
                + sum(f["launches"][k] for f in fits.values()) for k in counts}
    return {
        "nodes": int(batch.node_mask.sum()),
        "real_edges": steps["real_edges"],
        "node_budget": train_ds.node_budget,
        "edge_budget": train_ds.edge_budget,
        "frames": PLATE_FRAMES,
        "train_items": len(train_ds),
        "held_out_frames": frames,
        "world_edge_radius": radius,
        "world_edges_per_frame": per_frame,
        "data_s": data_s,
        "budgets_s": budgets_s,
        **host_ms,
        "host_ms_per_sample": sum(host_ms.values()),
        "host_samples_timed": HOST_SAMPLES,
        **{f"step_{k}": v for k, v in steps.items() if k not in ("graphs", "launches")},
        "step_launches": steps["launches"],
        "first_step_statistics": f"the {len(train_ds)} training items of the in-process fit's epoch",
        "loader_workers": workers,
        "fit_steps": steps_per_epoch,
        **{f"fit_{tag}_{k}": v for tag, f in fits.items() for k, v in f.items()
           if k not in ("trainer", "digests")},
        "fit_speedup_workers": fits["in_process"]["fit_s"] / fits["workers"]["fit_s"],
        "fit_batches_bit_equal": True,
        "host_items_per_s": 1e3 / sum(host_ms.values()),
        "loader_workers_items_per_s": workers_items_per_s,
        "predict_frames": frames,
        "predict_ms_per_frame": predict_s / frames * 1e3,
        "predict_launches": predict_launches,
        **cpu_check,
        "launches": launches,
    }


# ---------------------------------------------------------------------------
# bf16 compute, remat and the large mesh


def eight_byte_view(t):
    """A copy of ``t`` with its shape and strides in a buffer whose base is
    8 bytes past a 16-byte boundary: every node row of a bf16 width D % 4 ==
    0 8-byte, not 16-byte, aligned (the bf16 word geometry's 4-column
    words)."""
    flat = torch.empty(t.numel() + 8 // t.element_size(), dtype=t.dtype, device=t.device)[8 // t.element_size():]
    return flat.as_strided(t.shape, t.stride()).copy_(t)


def fused_bf16_case(name, graph, width, seed, heads=HEADS, view="model", library=True):
    """Hold the fused attention's bf16 entries (``csr_attention_bf16`` and
    ``csr_attention_bwd_bf16``, or in the word geometry
    ``csr_attention_bf16_words`` and ``csr_attention_bwd_bf16_words``)
    against their plain versions on the same bf16 inputs, the backward over
    the graph's transposed CSR (``gather_csr``, built once and timed on its
    own as ``transpose_ms``) and bit-equal on a second call, and time each
    beside its bound (bytes at 2 per q, k, v, out, g, dq, dk and dv
    element), its plain version, the f32 entry on the f32 inputs the bf16
    ones were rounded from and, with ``library``, SDPA in bf16 with the
    dense adjacency as its mask. ``view``: "model" (the model's (N, Dh, H)
    memory), "contiguous" or "model_8_byte" (the model's, every row base
    8-byte, not 16-byte, aligned: ``eight_byte_view``, its timed copies
    too). Returns (forward record, backward record)."""
    import torch.nn.functional as F

    from graphphysics_torch.ops import csr_attention as ca

    layout = "contiguous" if view == "contiguous" else "model"
    seg, gather, bounds, mask, f32s = attention_inputs(graph, width, seed, heads, layout)
    q, k, v, g = (t.to(torch.bfloat16) for t in f32s)  # in their layout: `to` keeps strides
    copy = eight_byte_view if view == "model_8_byte" else torch.clone  # clone keeps the strides
    if view == "model_8_byte":
        q, k, v, g = (copy(t) for t in (q, k, v, g))
    n, h = bounds.shape[1], heads
    scale = h ** -0.5
    interleaved = ca._is_interleaved(q)
    # with one head the model's (N, Dh, 1) layout is the contiguous one
    if heads > 1 and interleaved is not (layout == "model"):
        raise AssertionError(f"{name}: the bf16 inputs lost their layout")
    if ca._aligned(q, k, v, g) is (view == "model_8_byte"):
        raise AssertionError(f"{name}: the bf16 inputs' row alignment is not the view's")
    with torch.no_grad():
        tc = ca.gather_csr(seg, gather, bounds, mask)
        out, ml = ca.csr_attention(q, k, v, seg, gather, bounds, mask, scale)
        want_out, want_ml = ca.csr_attention_reference(q, k, v, seg, gather, n, mask, scale)
        grads = ca.csr_attention_backward(q, k, v, seg, gather, bounds, ml, out, g, mask, scale, tc)
        again = ca.csr_attention_backward(q, k, v, seg, gather, bounds, ml, out, g, mask, scale, tc)
        want_grads = ca.csr_attention_backward_reference(q, k, v, seg, gather, ml, out, g, mask, scale)
    torch.cuda.synchronize()
    if out.dtype != torch.bfloat16 or any(t.dtype != torch.bfloat16 for t in grads):
        raise AssertionError(f"{name}: bf16 entries gave {out.dtype}, {[t.dtype for t in grads]}")
    unequal = [f"d{x}" for x, a, b in zip("qkv", grads, again) if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"{name}: the bf16 backward gave other bits on a second call in {unequal}")
    fwd_errs = [(out.float() - want_out.float()).abs().max().item(), (ml - want_ml).abs().max().item()]
    if not (torch.isfinite(out.float()).all() and torch.allclose(
            out.float(), want_out.float(), rtol=BF16_KERNEL_RTOL, atol=BF16_KERNEL_ATOL)
            and torch.allclose(ml, want_ml, rtol=SOFTMAX_RTOL, atol=SOFTMAX_ATOL)):
        raise AssertionError(f"{name}: bf16 forward vs plain out/ml max_abs_err {fwd_errs}")
    bwd_errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(grads, want_grads)]
    shares = [(a != b).float().mean().item() for a, b in ((out, want_out), *zip(grads, want_grads))]
    if max(shares) > BF16_MISMATCH_SHARE:
        raise AssertionError(f"{name}: bf16 out/dq/dk/dv differ from plain in shares {shares} of elements")
    dv_atol = max(BF16_KERNEL_ATOL, BF16_DV_TERM * g.float().abs().max().item())
    for a, b, atol in zip(grads, want_grads, (BF16_KERNEL_ATOL, BF16_KERNEL_ATOL, dv_atol)):
        if not (torch.isfinite(a.float()).all() and torch.allclose(
                a.float(), b.float(), rtol=BF16_KERNEL_RTOL, atol=atol)):
            raise AssertionError(f"{name}: bf16 backward vs plain dq/dk/dv max_abs_err {bwd_errs}")
    edges_read = int((bounds[1] - bounds[0]).clamp(min=0).sum().item())
    real_edges = int(mask.sum().item())
    row = 2 * width  # bytes of a bf16 node row
    fwd_bytes = n * 3 * row + edges_read * 5 + n * 8 + n * row + n * 8 * h
    bwd_bytes = n * 5 * row + edges_read * 5 + n * 8 + n * 8 * h + n * 3 * row
    # f32 operations, as the f32 entry's (fused_case): the arithmetic is f32
    fwd_ops = real_edges * (4 * width + 6 * h) + n * width
    bwd_ops = real_edges * (11 * width + 6 * h) + n * 2 * width
    copies = copies_past_l2(fwd_bytes)
    sets = [(q, k, v, g)] + [tuple(copy(t) for t in (q, k, v, g)) for _ in range(copies - 1)]
    sets32 = [tuple(f32s)] + [tuple(t.clone() for t in f32s) for _ in range(copies - 1)]
    with torch.no_grad():
        saved = [ca.csr_attention(a, b, c, seg, gather, bounds, mask, scale) for a, b, c, _ in sets]
        saved32 = [ca.csr_attention(a, b, c, seg, gather, bounds, mask, scale) for a, b, c, _ in sets32]

        def fwd(a, b, c, _):
            return ca.csr_attention(a, b, c, seg, gather, bounds, mask, scale)

        def bwd(a, b, c, g_, o_, ml_):
            return ca.csr_attention_backward(a, b, c, seg, gather, bounds, ml_, o_, g_, mask, scale, tc)

        bwd_inputs = [(*st, *sv) for st, sv in zip(sets, saved)]
        bwd_inputs32 = [(*st, *sv) for st, sv in zip(sets32, saved32)]
        fwd_t, bwd_t = device_ms(fwd, sets), device_ms(bwd, bwd_inputs)
        f32_fwd_t, f32_bwd_t = device_ms(fwd, sets32), device_ms(bwd, bwd_inputs32)
        transpose_t = device_ms(lambda *_: ca.gather_csr(seg, gather, bounds, mask), sets)
        fwd_plain = device_ms(
            lambda a, b, c, _: ca.csr_attention_reference(a, b, c, seg, gather, n, mask, scale), sets)
        bwd_plain = device_ms(
            lambda a, b, c, g_, o_, ml_: ca.csr_attention_backward_reference(
                a, b, c, seg, gather, ml_, o_, g_, mask, scale), bwd_inputs)
    lib_fwd = lib_bwd = None
    lib_note = (f"n/a: SDPA needs a dense [{n}, {n}] mask ({n * n / 1e9:.1f} GB as bool) and "
                f"materializes scores of {2 * h * n * n / 1e9:.0f} GB in bf16")
    if library:
        adj, _ = dense_adjacency(seg, gather, mask, n)

        def sdpa(a, b, c):  # [N, H, Dh] -> [1, H, N, Dh]
            return F.scaled_dot_product_attention(
                a.transpose(0, 1)[None], b.transpose(0, 1)[None], c.transpose(0, 1)[None],
                attn_mask=adj, scale=scale)[0].transpose(0, 1)

        def sdpa_fwd_bwd(a, b, c, g_):
            leaves = [t.detach().requires_grad_(True) for t in (a, b, c)]
            return torch.autograd.grad(sdpa(*leaves), leaves, g_)

        with torch.no_grad():
            lib_fwd = device_ms(lambda a, b, c, _: sdpa(a, b, c), sets, min_reps=3)
        lib_bwd = device_ms(sdpa_fwd_bwd, sets, min_reps=3) - lib_fwd
        lib_note = "torch.nn.functional.scaled_dot_product_attention in bf16, dense boolean adjacency mask"
    geometry = {x: ca.bf16_geometry(width, h, interleaved, ca._aligned(q, k, v, g), backward=x == "backward")
                for x in ("forward", "backward")}
    common = {"shape": name, "nodes": n, "edges": seg.shape[0], "real_edges": real_edges,
              "width": width, "heads": h, "dtype": "bfloat16",
              "layout": {"model": "(N, Dh, H) view", "contiguous": "contiguous [N, H, Dh]",
                         "model_8_byte": "(N, Dh, H) view, rows 8-byte aligned"}[view],
              "lanes_per_row": {x: lanes for x, (lanes, _) in geometry.items()},
              "geometry": {x: kind for x, (_, kind) in geometry.items()},
              "f32_entry_lanes_per_row": {"forward": ca.lanes_per_row(width, h, interleaved),
                                          "backward": ca.lanes_per_row(width, h, interleaved, backward=True)},
              "input_copies": copies, "library_note": lib_note,
              "tolerance": {"rtol": BF16_KERNEL_RTOL, "atol": BF16_KERNEL_ATOL,
                            "mismatch_share": BF16_MISMATCH_SHARE}}

    def record(ms, plain, f32_ms, lib, bytes_, ops, errs, what):
        by_bytes, by_ops = bytes_ / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
        return {**common, "max_abs_err": max(errs), what: errs, "ms": ms, "plain_ms": plain,
                "f32_entry_ms": f32_ms, "library_ms": lib, "bound_ms": max(by_bytes, by_ops),
                "bound_by": "bytes" if by_bytes >= by_ops else "operations", "bytes": bytes_,
                "operations": ops}

    forward = record(fwd_t, fwd_plain, f32_fwd_t, lib_fwd, fwd_bytes, fwd_ops, fwd_errs, "out_ml_max_abs_err")
    forward["out_mismatch_share"] = shares[0]
    backward = record(bwd_t, bwd_plain, f32_bwd_t, lib_bwd, bwd_bytes, bwd_ops, bwd_errs,
                      "dq_dk_dv_max_abs_err")
    backward["tolerance"] = {**common["tolerance"], "dv_atol": dv_atol}
    backward["dq_dk_dv_mismatch_share"] = shares[1:]
    backward["bit_equal_twice"] = True
    backward["transpose_ms"] = transpose_t  # gather_csr, once a step on the training path
    return forward, backward


def with_precision(param, precision=None, **model):
    """A copy of ``param`` with ``"precision"`` and other model keys set."""
    param = json.loads(json.dumps(param))
    if precision is not None:
        model["precision"] = precision
    param["model"].update(model)
    return param


def f32_beside(result):
    """The f32 phase's readings a bf16 phase's line carries beside its own."""
    keys = ("ms_per_step", "peak_memory_gb", "launches_per_step", "first_loss", "last_loss")
    out = {k: result[k] for k in keys if k in result}
    breakdown = result.get("breakdown")
    if isinstance(breakdown, dict):
        out["device_ms_per_step"] = breakdown["device_ms_per_step"]
        out["kernels_per_step"] = breakdown["kernels_per_step"]
        out["device_ms_by_category"] = {k: v["ms_per_step"] for k, v in breakdown["by_category"].items()}
    return out


def bf16_train(name, param, batch, check_batch, counts, expected, seed, f32_result, graphs=len(BATCH_NODES)):
    """``train`` of ``param`` in bf16 on ``batch``, its first step against
    the CPU in bf16 on ``check_batch`` (one 2,048-node graph: a 15-block
    bf16 step on the host's CPU at 8 x 2,048 would take minutes), with the
    f32 phase's readings beside."""
    result = train(name, with_precision(param, "bf16"), batch, counts, expected, seed, BF16_GRAD_RTOL,
                   graphs=graphs, check_batch=check_batch, loss_rtol=BF16_STEP_LOSS_RTOL,
                   roundoff_share=BF16_ROUNDOFF_SHARE)
    result["first_step_batch"] = {"graphs": 1, "nodes": check_batch.num_nodes,
                                  "edges": check_batch.num_edges,
                                  "why": "the CPU side of a bf16 step at the timed batch is too slow"}
    result["f32_phase"] = f32_beside(f32_result)
    return result


def replay_bitwise(param, batch, seed, steps=2):
    """Whether two ``Trainer``s from one seeded state take ``steps`` steps
    on ``batch`` to the same bits (every loss and parameter), with the
    largest parameter difference: reported, not gated."""
    from graphphysics_torch.training import Trainer

    dev_batch = batch.to("cuda")
    runs = []
    for _ in range(2):
        trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda")
        trainer.init_state(steps + 1)
        losses = [trainer.train_step(dev_batch).item() for _ in range(steps)]
        runs.append((losses, {n: p.detach().clone() for n, p in trainer.sim.named_parameters()}))
        del trainer
    (loss_a, par_a), (loss_b, par_b) = runs
    return {"steps": steps, "bitwise": loss_a == loss_b and all(torch.equal(par_a[n], par_b[n]) for n in par_a),
            "losses_equal": loss_a == loss_b,
            "param_max_abs_diff": max((par_a[n] - par_b[n]).abs().max().item() for n in par_a)}


def remat_training(name, param, batch, counts, expected, seed):
    """The same first ``Trainer`` step with and without ``remat`` on the
    card from equal weights: each parameter's gradient within the atomics'
    round-off, the launches of each (``expected`` gives the plain run's per
    step; remat adds one forward launch a block, its recompute), then 5
    steps each timed with their peak memory."""
    from graphphysics_torch.training import Trainer

    runs, grads = {}, {}
    dev_batch = batch.to("cuda")
    for remat in (False, True):
        trainer = Trainer(with_precision(param, remat=remat), learning_rate=1e-4, warmup=10, seed=seed,
                          device="cuda")
        trainer.init_state(1 + REMAT_STEPS)
        for fn in counts.values():
            fn.launches = 0
        trainer.train_step(dev_batch)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counts.items()}
        want = {k: (2 * v if remat and k in REMAT_FORWARDS else v) for k, v in expected.items()}
        if launches != {k: want.get(k, 0) for k in counts}:
            raise AssertionError(f"{name}: remat={remat} launches {launches}, expected {want}")
        grads[remat] = {n: p.grad.detach().clone() for n, p in trainer.sim.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = [trainer.train_step(dev_batch) for _ in range(REMAT_STEPS)]
        torch.cuda.synchronize()
        runs[remat] = {"ms_per_step": (time.perf_counter() - t0) / REMAT_STEPS * 1e3,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
                       "launches_first_step": launches,
                       "last_loss": losses[-1].item()}
        del trainer
    rel = {n: ((grads[True][n] - g).norm() / g.norm()).item()
           for n, g in grads[False].items() if not n.endswith(ROUNDOFF_LEAVES)}
    worst = max(rel, key=rel.get)
    if not rel[worst] <= REMAT_GRAD_RTOL:
        raise AssertionError(f"{name}: remat gradient off by {rel[worst]} ({worst})")
    return {"nodes": batch.num_nodes, "edges": batch.num_edges, "steps_timed": REMAT_STEPS,
            "grad_rel_err_worst": rel[worst], "grad_worst_param": worst,
            "grad_rtol": REMAT_GRAD_RTOL, "plain": runs[False], "remat": runs[True],
            "peak_memory_ratio": runs[True]["peak_memory_gb"] / runs[False]["peak_memory_gb"],
            "launches": runs[True]["launches_first_step"]}


def learnable_target(pos, fields):
    """The large-mesh run's target: a smooth map of position (the same for
    every seed) plus a little of the fields."""
    rt = np.random.default_rng(7)
    w = rt.normal(size=(3, fields.shape[1])).astype(np.float32)
    b = rt.normal(size=(fields.shape[1],)).astype(np.float32)
    return (np.sin(pos @ w * 2.0 + b) * 0.1 + 0.05 * fields).astype(np.float32)


def learnable_graph(n, degree, out_dim, seed):
    """The large-mesh run's graph (``benchmarks/large_mesh_training.py``'s
    ``make_learnable_graph``, sender-sorted): ``degree * n`` random edges,
    positions uniform in [-1, 1]^3, ``out_dim`` random fields as features
    and a learnable target (``learnable_target``)."""
    from graphphysics_torch.core import pad_graph_csr_np

    e = degree * n
    r = np.random.default_rng(seed)
    pos = r.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    fields = r.normal(size=(n, out_dim)).astype(np.float32)
    x = np.zeros((n, out_dim + 2), np.float32)
    x[:, :out_dim] = fields
    return pad_graph_csr_np(x, pos, r.integers(0, n, e).astype(np.int32),
                            r.integers(0, n, e).astype(np.int32), n, e,
                            y=learnable_target(pos, fields), node_type_index=out_dim)


def learnable_microbatches(n, degree, out_dim, seed, count):
    """``count`` microbatches, stacked, on one topology (``learnable_graph``
    of ``seed``, so the host builds the mesh once), each with its own
    fields drawn from ``default_rng([seed, k])`` and their target."""
    from graphphysics_torch.core import stack_graphs

    base = learnable_graph(n, degree, out_dim, seed)
    graphs = []
    for k in range(count):
        fields = np.random.default_rng([seed, k]).normal(size=(n, out_dim)).astype(np.float32)
        x = base.x.copy()
        x[:, :out_dim] = fields
        graphs.append(base.replace(x=x, y=learnable_target(base.pos, fields)))
    return stack_graphs(graphs)


def large_mesh_training(lever, nodes, counts, seed):
    """The transformer 10 x 64 (4 heads, 2 outputs) trained on one learnable
    graph of ``nodes`` nodes and degree 8 with ``lever`` ("bf16", "remat" or
    "none"), or ("microbatch", f32) on ``LARGE_MESH_MICRO`` such graphs as
    the microbatches of one gradient-accumulation step: 3 warm-up and 10
    timed steps with the launches checked, the peak memory, the device time
    of 2 profiled steps, and the loss falling over the steps."""
    from graphphysics_torch.training import Trainer

    blocks = 10
    param = {"model": {"type": "transformer", "message_passing_num": blocks, "hidden_size": 64,
                       "node_input_size": 2, "output_size": 2, "edge_input_size": 0, "num_heads": 4,
                       "precision": "bf16" if lever == "bf16" else "f32", "remat": lever == "remat"},
             "index": {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
                       "output_index_end": 2, "node_type_index": 2}}
    micro = LARGE_MESH_MICRO if lever == "microbatch" else 1
    t0 = time.perf_counter()
    if micro > 1:
        graph = learnable_microbatches(nodes, LARGE_MESH_DEGREE, 2, seed, micro).to("cuda")
    else:
        graph = learnable_graph(nodes, LARGE_MESH_DEGREE, 2, seed).to("cuda")
    host_s = time.perf_counter() - t0
    trainer = Trainer(param, learning_rate=1e-3, warmup=LARGE_MESH_WARMUP, seed=seed, device="cuda",
                      gradient_accumulation=micro > 1)
    total = LARGE_MESH_WARMUP + LARGE_MESH_STEPS + PROFILED_LARGE_MESH
    trainer.init_state(total)
    losses = [trainer.train_step(graph) for _ in range(LARGE_MESH_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses += [trainer.train_step(graph) for _ in range(LARGE_MESH_STEPS)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    fwd, bwd = (("csr_attention_bf16", "csr_attention_backward_bf16") if lever == "bf16"
                else ("csr_attention", "csr_attention_backward"))
    per_step = {fwd: blocks * micro * (2 if lever == "remat" else 1), bwd: blocks * micro,
                "gather_csr": micro if lever == "bf16" else 0}
    want = {k: per_step.get(k, 0) * LARGE_MESH_STEPS for k in counts}
    if launches != want:
        raise AssertionError(f"large_mesh_training {lever}: launches {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [x.item() for x in losses]
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    if not (all(math.isfinite(x) for x in losses) and last < first):
        raise AssertionError(f"large_mesh_training {lever}: the loss did not fall: {losses}")
    ms_per_step = seconds / LARGE_MESH_STEPS * 1e3
    breakdown = device_breakdown(lambda: [trainer.train_step(graph) for _ in range(PROFILED_LARGE_MESH)],
                                 PROFILED_LARGE_MESH, unit="step")
    return {
        "lever": lever, "nodes": nodes, "edges": graph.num_edges, "microbatches": micro,
        "model": f"EncodeTransformDecode {blocks}x64, 4 heads, 2 outputs",
        "host_graph_s": host_s, "warmup_steps": LARGE_MESH_WARMUP, "steps_timed": LARGE_MESH_STEPS,
        "ms_per_step": ms_per_step, "edges_per_s": micro * graph.num_edges / (ms_per_step / 1e3),
        "peak_memory_gb": peak, "losses": losses,
        "loss_first3_mean": first, "loss_last3_mean": last,
        "launches": launches, "launches_per_step": {k: v / LARGE_MESH_STEPS for k, v in launches.items()},
        "device_ms_per_step": None if breakdown is None else breakdown["device_ms_per_step"],
        "device_ms_by_category": None if breakdown is None else
        {k: v["ms_per_step"] for k, v in breakdown["by_category"].items()},
        "device_idle_share": None if breakdown is None else
        1.0 - breakdown["device_ms_per_step"] / ms_per_step,
    }


def bf16_kernel_cases(clock, seed, tf_frames, tf_batch, aneurysm_csr) -> list:
    """The bf16 entries of the fused attention at their four shapes of the
    16-byte geometry and, on the panels batch, the word geometry's cases
    (``BF16_WORD_CASES``: ``fused_bf16_case``, SDPA timed once at each
    width and head count of ``BF16_WORD_LIBRARY``) and the general
    geometry at ``BF16_GENERAL_CASE``, then the bf16 stream twin at 48 x 4
    (``chip_stream.fused_stream_case``); returns the (forward, backward)
    records."""
    from chip_stream import fused_stream_case

    bf16_kernels = [
        fused_bf16_case("transformer_serving_frame", tf_frames[0], HIDDEN, seed + 40),
        fused_bf16_case("panels_csr_batch_8x2048", tf_batch, HIDDEN, seed + 41),
        fused_bf16_case("aneurysm_csr_66560x524288", aneurysm_csr, 64, seed + 42, library=False),
        fused_bf16_case("panels_csr_batch_8x2048_d64_h4", tf_batch, 64, seed + 43),
    ]
    library = {}
    for i, (d, h, view) in enumerate(BF16_WORD_CASES):
        f, b = fused_bf16_case(f"panels_csr_batch_8x2048_d{d}_h{h}_{view}", tf_batch, d, seed + 44 + i,
                               heads=h, view=view, library=(d, h) in BF16_WORD_LIBRARY and (d, h) not in library)
        if (d, h) in library:  # SDPA's time depends on the width and heads, not the view
            f["library_ms"], b["library_ms"] = library[d, h]
            f["library_note"] = b["library_note"] = "SDPA in bf16 as timed at the first case of this width"
        elif (d, h) in BF16_WORD_LIBRARY:
            library[d, h] = f["library_ms"], b["library_ms"]
        bf16_kernels.append((f, b))
    d, h, view = BF16_GENERAL_CASE
    f, b = fused_bf16_case(f"panels_csr_batch_8x2048_d{d}_h{h}_{view}", tf_batch, d, seed + 54, heads=h,
                           view=view, library=False)
    if set(f["geometry"].values()) != {"general"}:
        raise AssertionError(f"{f['shape']}: ran {f['geometry']}, not the general geometry")
    bf16_kernels.append((f, b))
    for f, b in bf16_kernels:
        clock.emit({"phase": "fused_bf16_kernels", "name": "csr_attention_bf16", **f})
        clock.emit({"phase": "fused_bf16_kernels", "name": "csr_attention_backward_bf16", **b})
    stream = fused_stream_case(BF16_WORD_SHAPE.replace("_model", ""), tf_batch, 48, seed + 53, torch.bfloat16)
    clock.emit({"phase": "fused_bf16_kernels", "name": "csr_attention_bf16_stream", **stream})
    return bf16_kernels


def bf16_phases(clock, counts, seed, frames, tf_frames, tf_batch, cyl_batch, panels, cylinder,
                epd_train, tf_train, gmm_train):
    """This slice's phases: bf16 training of both families and the GMM
    head, bf16 serving, remat, and the large mesh. Returns the path results
    by name."""
    paths = {}
    blocks = panels["model"]["message_passing_num"]
    epd_blocks = cylinder["model"]["message_passing_num"]
    check_epd = random_graph(BATCH_NODES[1], BATCH_EDGES[1], 2048, 12288, seed + 50)
    check_csr = random_csr_graph(BATCH_NODES[1], BATCH_EDGES[1], 2048, 12288, seed + 51)
    paths["bf16_epd_training"] = bf16_train(
        "bf16_epd_training", cylinder, cyl_batch, check_epd, counts,
        {"csr_segment_sum": epd_blocks, "csr_segment_sum_backward": epd_blocks}, seed, epd_train)
    clock.emit({"phase": "bf16_epd_training", "model": f"EncodeProcessDecode {epd_blocks}x128 bf16, "
                f"{CYLINDER_CONFIG}", **paths["bf16_epd_training"]})
    paths["bf16_transformer_training"] = bf16_train(
        "bf16_transformer_training", panels, tf_batch, check_csr, counts,
        {"csr_attention_bf16": blocks, "csr_attention_backward_bf16": blocks, "gather_csr": 1}, seed,
        tf_train)
    paths["bf16_transformer_training"]["replay"] = {
        "bf16": replay_bitwise(with_precision(panels, "bf16"), tf_batch, seed),
        "f32": replay_bitwise(panels, tf_batch, seed)}
    clock.emit({"phase": "bf16_transformer_training", "model": f"EncodeTransformDecode {blocks}x128, 4 heads, "
                f"bf16, {PANELS_CONFIG}", **paths["bf16_transformer_training"]})
    gmm = load_config(GMM_CONFIG)
    gmm_blocks = gmm["model"]["message_passing_num"]
    check_gmm = random_csr_graph(BATCH_NODES[1], BATCH_EDGES[1], 2048, 12288, seed + 52, columns=15,
                                 node_type_index=14)
    paths["bf16_gmm_training"] = bf16_train(
        "bf16_gmm_training", gmm, aneurysm_gmm_graph(seed + 400), check_gmm, counts,
        {"csr_attention_bf16": gmm_blocks, "csr_attention_backward_bf16": gmm_blocks, "gather_csr": 1},
        seed, gmm_train, graphs=1)
    clock.emit({"phase": "bf16_gmm_training", "model": f"EncodeTransformDecode {gmm_blocks}x64, K=3, bf16, "
                f"{GMM_CONFIG}", **paths["bf16_gmm_training"]})

    # bf16 serving: 50-frame rollouts of both families, CUDA-graph replays
    _, result, profile_line = serve(
        "bf16_epd_serving", lambda s, dev: build_epd(s, dev, torch.bfloat16), frames, counts,
        {"csr_segment_sum": BLOCKS}, seed, rtol=BF16_ROLLOUT_RTOL, atol=BF16_ROLLOUT_ATOL)
    clock.emit({"phase": "bf16_serving", "model": f"EncodeProcessDecode {BLOCKS}x{HIDDEN} bf16",
                **result, **profile_line})
    _, result, profile_line = serve(
        "bf16_transformer_serving", lambda s, dev: build_transformer(with_precision(panels, "bf16"), s, dev),
        tf_frames, counts, {"csr_attention_bf16": blocks}, seed,
        rtol=BF16_ROLLOUT_RTOL, atol=BF16_ROLLOUT_ATOL)
    clock.emit({"phase": "bf16_serving", "model": f"EncodeTransformDecode {blocks}x128 bf16, {PANELS_CONFIG}",
                **result, **profile_line})

    # remat: the same steps with each block recomputed in the backward
    paths["remat_transformer_training"] = remat_training(
        "remat_transformer_training", panels, tf_batch, counts,
        {"csr_attention": blocks, "csr_attention_backward": blocks}, seed)
    clock.emit({"phase": "remat_training", "model": f"EncodeTransformDecode {blocks}x128, {PANELS_CONFIG}",
                **paths["remat_transformer_training"]})
    paths["remat_epd_training"] = remat_training(
        "remat_epd_training", cylinder, cyl_batch, counts,
        {"csr_segment_sum": epd_blocks, "csr_segment_sum_backward": epd_blocks}, seed)
    clock.emit({"phase": "remat_training", "model": f"EncodeProcessDecode {epd_blocks}x128, {CYLINDER_CONFIG}",
                **paths["remat_epd_training"]})

    # the large mesh: the three levers of benchmarks/large_mesh_training.py,
    # and microbatches of the f32 graph as a fourth
    for lever, nodes in LARGE_MESH:
        label = f"large_mesh_training:{lever}"
        paths[label] = large_mesh_training(lever, nodes, counts, seed)
        if lever == "microbatch":
            one = paths["large_mesh_training:none"]["peak_memory_gb"]
            paths[label]["one_graph_peak_memory_gb"] = one
            paths[label]["peak_memory_ratio"] = paths[label]["peak_memory_gb"] / one
            paths[label]["peak_memory_ratio_limit"] = LARGE_MESH_MICRO_PEAK
            if not paths[label]["peak_memory_ratio"] <= LARGE_MESH_MICRO_PEAK:
                raise AssertionError(f"{label}: peak memory {paths[label]['peak_memory_gb']} GB against "
                                     f"the one-graph step's {one} GB")
        clock.emit({"phase": "large_mesh_training", **paths[label]})
        torch.cuda.empty_cache()
    return paths


def grad_accum(name, param, graphs, counts, expected, seed, grad_rtol):
    """One ``Trainer`` step over ``graphs`` as the microbatches of a
    gradient-accumulation step (stacked) against the plain step on their
    concatenation, on the card from equal weights: the loss within
    ``STEP_LOSS_RTOL``, each parameter's gradient within ``grad_rtol``
    (the round-off-only key biases held apart, ReLU inputs of another sign
    counted, as ``first_step``), every normalizer's counter at exactly 1.
    Then each trainer's 3 warm-up and ``ACCUM_TIMED_STEPS`` timed steps,
    launches counted (``expected``: per block and graph batch; the
    microbatch step launches it once per microbatch) and peak memory above
    what the card held when the phase began; the microbatch step's peak
    must stay under ``ACCUM_PEAK_SHARE`` of the concat step's."""
    from graphphysics_torch.core import concat_graphs, stack_graphs
    from graphphysics_torch.models.simulator import Normalizer
    from graphphysics_torch.training import Trainer

    m = len(graphs)
    # what earlier phases still hold is not this phase's: peaks are taken
    # above it
    floor = torch.cuda.memory_allocated()
    batches = {False: concat_graphs(graphs).to("cuda"), True: stack_graphs(graphs).to("cuda")}
    runs = {}
    for accumulate in (False, True):
        trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda",
                          gradient_accumulation=accumulate)
        trainer.init_state(1 + WARMUP_STEPS + ACCUM_TIMED_STEPS)
        batch, signs = batches[accumulate], []
        hooks = relu_sign_hooks(trainer.sim, signs)
        loss = trainer.train_step(batch).item()
        for hook in hooks:
            hook.remove()
        grads = {n: p.grad.detach().cpu() for n, p in trainer.sim.named_parameters()}
        counters = [b._num_accumulations.item() for b in trainer.sim.modules() if isinstance(b, Normalizer)]
        for _ in range(WARMUP_STEPS):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses = [trainer.train_step(batch) for _ in range(ACCUM_TIMED_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
        per = m if accumulate else 1
        want = {k: expected.get(k, 0) * per * ACCUM_TIMED_STEPS for k in counts}
        if launches != want:
            raise AssertionError(f"{name}: accumulate={accumulate} launches {launches}, expected {want}")
        losses = [x.item() for x in losses]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        runs[accumulate] = {"loss": loss, "grads": grads, "signs": signs, "counters": counters,
                            "ms_per_step": seconds / ACCUM_TIMED_STEPS * 1e3,
                            "peak_memory_gb": (torch.cuda.max_memory_allocated() - floor) / 2**30,
                            "launches": launches, "first_loss": losses[0], "last_loss": losses[-1]}
        del trainer
    concat, micro = runs[False], runs[True]
    # ReLU inputs in the concat's order: block by block, each the
    # microbatches' rows in turn (every input's width is a multiple of 8)
    layers = len(concat["signs"])
    reordered = [np.concatenate([micro["signs"][k * layers + i] for k in range(m)]) for i in range(layers)]
    flips = sum(int(np.unpackbits(a ^ b).sum()) for a, b in zip(concat["signs"], reordered))
    roundoff = [n for n in concat["grads"] if n.endswith(ROUNDOFF_LEAVES)]
    rel = {n: ((micro["grads"][n] - g).norm() / g.norm()).item()
           for n, g in concat["grads"].items() if n not in roundoff}
    worst = max(rel, key=rel.get)
    share = 0.0
    for run in (concat, micro):
        top = max(g.abs().max().item() for n, g in run["grads"].items() if n not in roundoff)
        share = max([share] + [run["grads"][n].abs().max().item() / top for n in roundoff])
    loss_err = abs(micro["loss"] - concat["loss"]) / abs(concat["loss"])
    ratio = micro["peak_memory_gb"] / concat["peak_memory_gb"]
    result = {
        "microbatches": m, "nodes_per_microbatch": graphs[0].num_nodes,
        "edges_per_microbatch": graphs[0].num_edges,
        "real_nodes": [int(np.asarray(g.node_mask).sum()) for g in graphs],
        "concat_loss": concat["loss"], "microbatch_loss": micro["loss"], "loss_rel_err": loss_err,
        "grad_rel_err_worst": rel[worst], "grad_worst_param": worst,
        "grad_rel_err_median": float(np.median(list(rel.values()))),
        "relu_inputs": sum(8 * len(a) for a in concat["signs"]), "relu_sign_flips": flips,
        "roundoff_share": share, "normalizer_counters": micro["counters"],
        "tolerance": {"loss_rtol": STEP_LOSS_RTOL, "grad_rtol_per_param": grad_rtol,
                      "roundoff_share": STEP_ROUNDOFF_SHARE, "peak_share": ACCUM_PEAK_SHARE},
        "ms_per_step": micro["ms_per_step"], "concat_ms_per_step": concat["ms_per_step"],
        "peak_memory_gb": micro["peak_memory_gb"], "concat_peak_memory_gb": concat["peak_memory_gb"],
        "peak_memory_ratio": ratio, "held_before_gb": floor / 2**30, "steps_timed": ACCUM_TIMED_STEPS,
        "launches": micro["launches"],
        "launches_per_step": {k: v / ACCUM_TIMED_STEPS for k, v in micro["launches"].items()},
        "concat_launches_per_step": {k: v / ACCUM_TIMED_STEPS for k, v in concat["launches"].items()},
        "first_loss": micro["first_loss"], "last_loss": micro["last_loss"],
    }
    if not (math.isfinite(micro["loss"]) and loss_err <= STEP_LOSS_RTOL and rel[worst] <= grad_rtol
            and share <= STEP_ROUNDOFF_SHARE):
        raise AssertionError(f"{name}: the microbatch step is not the concat step: {result}")
    if micro["counters"] != [1.0] * len(micro["counters"]):
        raise AssertionError(f"{name}: normalizer counters {micro['counters']} after one step")
    if not ratio < ACCUM_PEAK_SHARE:
        raise AssertionError(f"{name}: microbatch peak {ratio} of the concat step's: more than one "
                             f"microbatch's activations alive")
    return result


def with_dataset(param, **dataset):
    """A copy of ``param`` with dataset keys set."""
    param = json.loads(json.dumps(param))
    param.setdefault("dataset", {}).update(dataset)
    return param


def timed_steps(name, param, batch, counts, expected, seed, stats):
    """``WARMUP_STEPS`` then ``ELL_TIMED_STEPS`` ``Trainer`` steps of ``param``
    on ``batch`` on the card (normalizer statistics ``stats``), launches
    counted from 0 and checked against ``expected`` per step. Returns the
    ms per step and the launches."""
    from graphphysics_torch.training import Trainer

    trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda")
    trainer.init_state(WARMUP_STEPS + ELL_TIMED_STEPS)
    trainer.sim.load_state_dict(stats, strict=False)
    dev_batch = batch.to("cuda")
    for _ in range(WARMUP_STEPS):
        trainer.train_step(dev_batch)
    torch.cuda.synchronize()
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [trainer.train_step(dev_batch) for _ in range(ELL_TIMED_STEPS)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ELL_TIMED_STEPS * 1e3
    launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: expected.get(k, 0) * ELL_TIMED_STEPS for k in counts}
    if launches != want or not all(math.isfinite(x.item()) for x in losses):
        raise AssertionError(f"{name}: launches {launches} (expected {want}), losses {losses}")
    return ms, launches


def compare_steps(name, what, step_a, step_b, seed, grad_rtol, stats=None):
    """The first ``Trainer`` step of ``step_a`` against that of ``step_b``
    (each a ``(param, batch)``: the same function on the same frames in
    another form), on the card from equal weights and, where given, equal
    normalizer statistics ``stats``: the loss within ``STEP_LOSS_RTOL``,
    each parameter's gradient within ``grad_rtol`` (the round-off-only key
    biases apart), the normalizer statistics within 1e-6 of the largest
    and their counts exactly. Readings are keyed ``{what}_*``."""
    from graphphysics_torch.training import Trainer

    out = []
    for param, batch in (step_a, step_b):
        trainer = Trainer(param, learning_rate=1e-4, warmup=10, seed=seed, device="cuda")
        trainer.init_state(1)
        if stats is not None:
            trainer.sim.load_state_dict(stats, strict=False)
        loss = trainer.train_step(batch).item()
        out.append((loss, {n: p.grad.detach().cpu() for n, p in trainer.sim.named_parameters()},
                    {k: v.cpu() for k, v in trainer.sim.state_dict().items() if "_normalizer." in k}))
        del trainer
    (loss_a, grads_a, stats_a), (loss_b, grads_b, stats_b) = out
    rel = {n: ((grads_a[n] - g).norm() / g.norm()).item()
           for n, g in grads_b.items() if not n.endswith(ROUNDOFF_LEAVES)}
    worst = max(rel, key=rel.get)
    stats_err = max((stats_a[k] - v).abs().max().item() / max(v.abs().max().item(), 1.0)
                    for k, v in stats_b.items())
    counts_equal = all(torch.equal(stats_a[k], v) for k, v in stats_b.items()
                       if k.endswith(("_acc_count", "_num_accumulations")))
    result = {f"{what}_loss": loss_a, f"{what}_reference_loss": loss_b,
              f"{what}_loss_rel_err": abs(loss_a - loss_b) / abs(loss_b),
              f"{what}_grad_rel_err_worst": rel[worst], f"{what}_grad_worst_param": worst,
              f"{what}_grad_rel_err_median": float(np.median(list(rel.values()))),
              f"{what}_stats_rel_err": stats_err, f"{what}_counts_equal": counts_equal,
              f"{what}_tolerance": {"loss_rtol": STEP_LOSS_RTOL, "grad_rtol_per_param": grad_rtol}}
    if not (result[f"{what}_loss_rel_err"] <= STEP_LOSS_RTOL and rel[worst] <= grad_rtol
            and stats_err <= 1e-6 and counts_equal):
        raise AssertionError(f"{name}: {what} check out of tolerance: {result}")
    return result


def ell_pipeline(name, param, make_traj, counts, own_expected, seed, grad_rtol):
    """``param`` with ``"edge_layout": "ell"`` on two synthetic
    trajectories (``memory_datasets``, 2,048 nodes): ``Trainer.fit`` for one
    epoch with rollout validation, a reload and ``predict`` over a held-out
    trajectory of ``PREDICT_FRAMES`` frames, its frames against the CPU's,
    and not one kernel launch on any of it (the ELL layout's ops are
    dense PyTorch ops on every device). Then the first ELL step on the card
    against the CPU (``first_step``, from the fit's normalizer statistics),
    the same step against the model's own layout (sorted or CSR, its
    kernels) on the same frames (``compare_steps``), and ``ELL_TIMED_STEPS`` steps of each layout
    timed (``own_expected``: the kernels' launches per step)."""
    import tempfile

    import chip_fidelity
    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer, load_checkpoint
    from graphphysics_torch.utils.synthetic import write_json

    ell = with_dataset(param, edge_layout="ell")
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = memory_datasets(ell, make_traj, seed, tmp, n_traj=2)
        own_ds, _ = memory_datasets(param, make_traj, seed, tmp, n_traj=2)
        short_meta = write_json(f"{tmp}/meta_short.json", make_traj(steps=PREDICT_FRAMES + 1, nx=2, ny=2)[1])
        held_out = chip_fidelity.memory_split(
            ell, [make_traj(steps=PREDICT_FRAMES + 1, nx=64, ny=32, phase0=0.7)[0]], short_meta, val=True,
            seed=seed)
        loader = GraphLoader(train_ds, batch_size=8, shuffle=True, seed=seed)
        trainer = Trainer(ell, learning_rate=1e-4, warmup=2, seed=seed, device="cuda", checkpoint_dir=tmp,
                          metrics_path=None, rollout_dir=None)
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        history = trainer.fit(loader, val_dataset=val_ds, num_epochs=1, val_trajectories=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        reloaded = Trainer(ell, seed=seed, device="cuda", metrics_path=None, rollout_dir=None)
        reloaded.init_state(1)
        load_checkpoint(f"{tmp}/state.pt", reloaded.sim)
        t0 = time.perf_counter()
        preds = reloaded.predict(held_out, save_dir=None)
        predict_ms = (time.perf_counter() - t0) / PREDICT_FRAMES * 1e3
        frames = stack_graphs([held_out[i] for i in held_out.trajectory_indices(0)])
        check = rollout_against_cpu(name, ell, reloaded.sim, frames, seed)
        launches = {k: fn.launches for k, fn in counts.items()}
        if any(launches.values()):
            raise AssertionError(f"{name}: the ELL path launched kernels: {launches}")
        values = history["train_loss"] + history["val_rmse"] + [float(np.abs(preds[0]).max())]
        if not all(math.isfinite(v) for v in values) or preds[0].shape[0] != PREDICT_FRAMES:
            raise AssertionError(f"{name}: fit {history}, predict {[p.shape for p in preds]}")
        stats = {k: v.cpu() for k, v in trainer.sim.state_dict().items() if "_normalizer." in k}
        batch = loader.peek()
        own_batch = GraphLoader(own_ds, batch_size=8, shuffle=True, seed=seed).peek()
        first = first_step(name, ell, batch, seed, 1, grad_rtol, stats=stats)
        layout = compare_steps(name, "layout", (ell, batch), (param, own_batch), seed, grad_rtol, stats)
        ell_ms, ell_launches = timed_steps(name, ell, batch, counts, {}, seed, stats)
        own_ms, _ = timed_steps(name, param, own_batch, counts, own_expected, seed, stats)
    return {
        "items": len(train_ds), "nodes": batch.num_nodes, "edges": batch.num_edges,
        "ell_degree": train_ds.ell_degree, "own_layout": own_ds.edge_layout,
        "own_layout_edges": own_batch.num_edges, "real_edges": int(np.asarray(batch.edge_mask).sum()),
        "fit_s": fit_s, "train_loss": history["train_loss"], "val_rmse": history["val_rmse"],
        "predict_frames": PREDICT_FRAMES, "predict_ms_per_frame": predict_ms, **check, **first, **layout,
        "launches": launches, "timed_launches": ell_launches,
        "ms_per_step": ell_ms, "own_layout_ms_per_step": own_ms, "steps_timed": ELL_TIMED_STEPS,
    }


def bucket_datasets(param, seed, directory, num_buckets):
    """Training and held-out ``MemoryDataset``s of synthetic cylinder
    trajectories of ``BUCKET_SIZES`` (the h5 layout in memory: the card's
    machine has no h5py), ``num_buckets`` size buckets."""
    from graphphysics_torch.dataset import MemoryDataset
    from graphphysics_torch.training import get_preprocessing
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, write_json

    meta = write_json(f"{directory}/meta.json", cylinder_trajectory(steps=BUCKET_FRAMES, nx=2, ny=2)[1])
    train, held_out = [], []
    for nx, ny, count in BUCKET_SIZES:
        train += [cylinder_trajectory(BUCKET_FRAMES, nx, ny, phase0=0.15 * k)[0] for k in range(count)]
        held_out.append(cylinder_trajectory(BUCKET_FRAMES, nx, ny, phase0=1.1)[0])
    common = dict(add_edge_features=True, node_type_index=param["index"]["node_type_index"], seed=seed,
                  num_buckets=num_buckets)
    return (MemoryDataset(train, meta, preprocessing=get_preprocessing(param), **common),
            MemoryDataset(held_out, meta, preprocessing=get_preprocessing(param, remove_noise=True),
                          **common))


def bucketed_pipeline(name, param, counts, expected, seed):
    """``param`` (the cylinder EPD) on trajectories of three mesh sizes in 2
    size buckets (``bucket_datasets``), batches of ``BUCKET_BATCH``:
    ``Trainer.fit`` for one epoch with rollout validation, in-process and
    with ``BUCKET_WORKERS`` loader workers (the batches bit-equal), and
    with one bucket for comparison. Checked: every batch's graphs padded to
    one of the bucket budgets, the small bucket's batch present and filled
    with a masked copy, the launches (``expected``: per step and validated
    frame), and on the card the filled batch's step against its real graphs
    alone (``compare_steps``)."""
    import tempfile

    from graphphysics_torch.core import concat_graphs, masked_filler
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer

    fits = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, buckets, workers in (("buckets", 2, 0), ("buckets_workers", 2, BUCKET_WORKERS),
                                        ("one_bucket", 1, 0)):
            train_ds, val_ds = bucket_datasets(param, seed, tmp, buckets)
            loader = GraphLoader(train_ds, batch_size=BUCKET_BATCH, shuffle=True, seed=seed,
                                 num_workers=workers)
            recorder = RecordingLoader(loader)
            trainer = Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda",
                              checkpoint_dir=tmp, metrics_path=None, rollout_dir=None)
            for fn in counts.values():
                fn.launches = 0
            t0 = time.perf_counter()
            try:
                history = trainer.fit(recorder, val_dataset=val_ds, num_epochs=1)
            finally:
                loader.close()
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counts.items()}
            frames = val_ds.size_dataset * val_ds.frames_per_trajectory
            want = {k: expected.get(k, (0, 0))[0] * len(loader) + expected.get(k, (0, 0))[1] * frames
                    for k in counts}
            if launches != want:
                raise AssertionError(f"{name} {label}: launches {launches}, expected {want}")
            if not all(math.isfinite(v) for v in history["train_loss"] + history["val_rmse"]):
                raise AssertionError(f"{name} {label}: non-finite history {history}")
            fits[label] = {"fit_s": fit_s, "batches": len(loader), "digests": recorder.digests,
                           "shapes": recorder.shapes, "fillers": recorder.fillers,
                           "real_node_rows": recorder.real_rows, "history": history,
                           "launches": launches, "budgets": train_ds._bucket_node_budgets,
                           "node_budget": train_ds.node_budget}
        bucketed = fits["buckets"]
        if fits["buckets_workers"]["digests"] != bucketed["digests"]:
            raise AssertionError(f"{name}: the workers' batches differ from the in-process ones")
        budgets = bucketed["budgets"]
        per_graph = [n // BUCKET_BATCH for n, _ in bucketed["shapes"]]
        if not set(per_graph) <= set(budgets) or len(set(per_graph)) != len(budgets):
            raise AssertionError(f"{name}: batch node counts {per_graph}, bucket budgets {budgets}")
        small = [i for i, n in enumerate(per_graph) if n == budgets[0]]
        if len(small) != 1 or bucketed["fillers"][small[0]] != BUCKET_BATCH - BUCKET_SIZES[0][2] * (
                BUCKET_FRAMES - 1):
            raise AssertionError(f"{name}: the small bucket's batches {small}, fillers {bucketed['fillers']}")
        # the filled batch against its real graphs alone, on the card
        train_ds, _ = bucket_datasets(param, seed, tmp, 2)
        real = [train_ds[i] for i in range(BUCKET_SIZES[0][2] * (BUCKET_FRAMES - 1))]
        filled = real + [masked_filler(real[-1])] * (BUCKET_BATCH - len(real))
        filler = {"filler_graphs": len(filled) - len(real),
                  **compare_steps(name, "filler", (param, concat_graphs(filled)), (param, concat_graphs(real)),
                                  seed, EPD_GRAD_RTOL)}

    def padded_share(fit):
        rows = sum(n for n, _ in fit["shapes"])
        return 1.0 - sum(fit["real_node_rows"]) / rows

    return {
        "sizes": [{"nodes": nx * ny, "trajectories": k} for nx, ny, k in BUCKET_SIZES],
        "frames": BUCKET_FRAMES, "batch_size": BUCKET_BATCH, "workers": BUCKET_WORKERS,
        "bucket_node_budgets": budgets, "batch_nodes_per_graph": per_graph,
        "fillers_per_batch": bucketed["fillers"],
        "fit_s": bucketed["fit_s"], "fit_workers_s": fits["buckets_workers"]["fit_s"],
        "one_bucket_fit_s": fits["one_bucket"]["fit_s"],
        "batches": bucketed["batches"], "one_bucket_batches": fits["one_bucket"]["batches"],
        "padded_node_share": padded_share(bucketed),
        "one_bucket_padded_node_share": padded_share(fits["one_bucket"]),
        "one_bucket_node_budget": fits["one_bucket"]["node_budget"],
        "train_loss": bucketed["history"]["train_loss"], "val_rmse": bucketed["history"]["val_rmse"],
        "workers_batches_equal": True, **filler, "launches": bucketed["launches"],
    }


def project_before_gather_phase(graph, seed):
    """One 128-wide ``GraphNetBlock`` with ``project_before_gather`` against
    the plain block with the same weights on ``graph`` (the flagship batch,
    receiver-sorted: K1 and K1b run in both) on the card: the outputs within
    ``KERNEL_ATOL`` of each other; the backward of each (the gradients of x,
    edge_attr and every parameter) held against the plain block in f64 on
    the CPU, the split block's error within ``PBG_ERROR_FACTOR`` times the
    plain block's own f32 error (gradients summed over 98,304 edges cancel,
    so neither is near ``KERNEL_ATOL`` there); then each block's forward,
    and forward with backward, timed in turns (plain, split, split, plain),
    eager, with their device time."""
    from graphphysics_torch.models.layers import GraphNetBlock, reset_parameters

    gen = torch.Generator().manual_seed(seed)
    plain = reset_parameters(GraphNetBlock(HIDDEN), gen)
    reference = GraphNetBlock(HIDDEN).double()
    reference.load_state_dict(plain.state_dict(), strict=True)
    plain = plain.to("cuda")
    split = GraphNetBlock(HIDDEN, project_before_gather=True).to("cuda")
    split.load_state_dict(plain.state_dict(), strict=True)
    host = graph.to("cpu")
    inputs = [torch.randn(n, HIDDEN, generator=gen) for n in (host.num_nodes, host.num_edges) * 2]

    def forward_backward(block, x, ea, gx, ge, g):
        xi, ei = x.clone().requires_grad_(True), ea.clone().requires_grad_(True)
        out = block(xi, ei, g.senders, g.receivers, g.edge_mask, g.row_bounds)
        return out, torch.autograd.grad(out, [xi, ei] + list(block.parameters()), (gx, ge))

    want_out, want_grads = forward_backward(reference, *[t.double() for t in inputs], host)
    dev = graph.to("cuda")
    card = [t.to("cuda") for t in inputs]
    names = ["x", "edge_attr"] + [f"param:{n}" for n, _ in plain.named_parameters()]
    outs, errors = {}, {}
    for label, block in (("plain", plain), ("split", split)):
        out, grads = forward_backward(block, *card, dev)
        outs[label] = out
        errors[label] = {n: ((a.double().cpu() - b).norm() / b.norm()).item()
                         for n, a, b in zip(names, grads, want_grads)}
    out_err = max((a - b).abs().max().item() for a, b in zip(outs["split"], outs["plain"]))
    ratio = {n: errors["split"][n] / max(errors["plain"][n], 1e-7) for n in names}
    worst = max(ratio, key=ratio.get)

    def forward(block):
        with torch.no_grad():
            return block(card[0], card[1], dev.senders, dev.receivers, dev.edge_mask, dev.row_bounds)

    times = {}
    for label, block in (("plain", plain), ("split", split), ("split", split), ("plain", plain)):
        times.setdefault(label, {"forward_ms": [], "forward_backward_ms": []})
        times[label]["forward_ms"].append(call_ms(lambda: forward(block)))
        times[label]["forward_backward_ms"].append(call_ms(lambda: forward_backward(block, *card, dev)))
    device = {}
    for label, block in (("plain", plain), ("split", split)):
        breakdown = device_breakdown(lambda: [forward_backward(block, *card, dev) for _ in range(5)], 5,
                                     unit="call")
        device[label] = None if breakdown is None else breakdown["device_ms_per_call"]
    result = {
        "nodes": dev.num_nodes, "edges": dev.num_edges, "width": HIDDEN,
        "out_max_abs_err": out_err, "tolerance": KERNEL_ATOL,
        "grad_rel_err_vs_f64_plain_worst": max(errors["plain"].values()),
        "grad_rel_err_vs_f64_split_worst": max(errors["split"].values()),
        "grad_err_ratio_worst": ratio[worst], "grad_err_ratio_worst_of": worst,
        "grad_err_ratio_limit": PBG_ERROR_FACTOR,
        "plain": {k: float(np.mean(v)) for k, v in times["plain"].items()},
        "split": {k: float(np.mean(v)) for k, v in times["split"].items()},
        "plain_device_ms_fwd_bwd": device["plain"], "split_device_ms_fwd_bwd": device["split"],
    }
    result["split_over_plain_forward_backward"] = (result["split"]["forward_backward_ms"]
                                                   / result["plain"]["forward_backward_ms"])
    if not (out_err <= KERNEL_ATOL and ratio[worst] <= PBG_ERROR_FACTOR):
        raise AssertionError(f"project_before_gather: not the plain block: {result}")
    return result


def training_feature_phases(clock, counts, seed, cylinder, panels, cyl_graphs, tf_graphs):
    """The training-feature phases: gradient accumulation of both families, the ELL
    pipeline of both, the bucketed pipeline and project_before_gather
    (the large mesh's microbatch lever runs with the other levers). Returns
    the path results by name."""
    from graphphysics_torch.core import concat_graphs
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    paths = {}
    blocks = panels["model"]["message_passing_num"]
    epd_blocks = cylinder["model"]["message_passing_num"]
    epd_kernels = {"csr_segment_sum": epd_blocks, "csr_segment_sum_backward": epd_blocks}
    tf_kernels = {"csr_attention": blocks, "csr_attention_backward": blocks}
    paths["grad_accum_epd"] = grad_accum("grad_accum_epd", cylinder, cyl_graphs, counts, epd_kernels, seed,
                                         EPD_GRAD_RTOL)
    clock.emit({"phase": "grad_accum_epd", "model": f"EncodeProcessDecode {epd_blocks}x128, "
                f"{CYLINDER_CONFIG}", **paths["grad_accum_epd"]})
    torch.cuda.empty_cache()
    paths["grad_accum_transformer"] = grad_accum("grad_accum_transformer", panels, tf_graphs, counts,
                                                 tf_kernels, seed, TRANSFORMER_GRAD_RTOL)
    clock.emit({"phase": "grad_accum_transformer", "model": f"EncodeTransformDecode {blocks}x128, "
                f"{PANELS_CONFIG}", **paths["grad_accum_transformer"]})
    torch.cuda.empty_cache()
    for label, param, make_traj, kernels, rtol in (
            ("ell_pipeline:cylinder", cylinder, cylinder_trajectory, epd_kernels, EPD_GRAD_RTOL),
            ("ell_pipeline:panels", panels, panels_trajectory, tf_kernels, TRANSFORMER_GRAD_RTOL)):
        paths[label] = ell_pipeline(label, param, make_traj, counts, kernels, seed, rtol)
        clock.emit({"phase": "ell_pipeline", "config": label.split(":")[1], **paths[label]})
    paths["bucketed_pipeline"] = bucketed_pipeline(
        "bucketed_pipeline", cylinder, counts,
        {"csr_segment_sum": (epd_blocks, epd_blocks), "csr_segment_sum_backward": (epd_blocks, 0)}, seed)
    clock.emit({"phase": "bucketed_pipeline", "model": f"EncodeProcessDecode {epd_blocks}x128, "
                f"{CYLINDER_CONFIG}", **paths["bucketed_pipeline"]})
    clock.emit({"phase": "project_before_gather",
                **project_before_gather_phase(concat_graphs(cyl_graphs), seed)})
    return paths


def fidelity_short(name, counts, config):
    """``FIDELITY_SHORT_EPOCHS`` epochs of ``chip_fidelity.run`` for
    ``config`` (plain head) on the card, launch counts zeroed just before:
    the training loss and the held-out rollout RMSE fall, and the run's
    kernels ran."""
    import tempfile

    import chip_fidelity

    for fn in counts.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = chip_fidelity.run(tmp, epochs=FIDELITY_SHORT_EPOCHS, device="cuda", config=config)
    launches = {k: fn.launches for k, fn in counts.items()}
    losses, rmse = out["train_loss_by_epoch"], out["val_all_rollout_rmse_by_epoch"]
    if not (all(math.isfinite(v) for v in losses + rmse) and losses[-1] < losses[0]
            and rmse[-1] < rmse[0]):
        raise AssertionError(f"{name}: the loss or the rollout RMSE did not fall: {out}")
    if any(launches[k] == 0 for k in FIDELITY_KERNELS[config]):
        raise AssertionError(f"{name}: the kernels of the run did not run: {launches}")
    return {**out, "launches": launches}


def batch_digest(batch) -> str:
    """A digest of every field of a batch."""
    h = hashlib.sha1()
    for field in dataclasses.fields(batch):
        value = getattr(batch, field.name)
        if value is not None:
            h.update(field.name.encode())
            h.update(np.ascontiguousarray(value).tobytes())
    return h.hexdigest()


class RecordingLoader:
    """A ``GraphLoader`` that records a digest of each batch it yields
    (``batch_digest``), when it yielded it, its (nodes, edges), its real
    node rows and its fully masked graphs (fillers), and, given a trainer,
    asks it to stop after batch ``stop_after``."""

    def __init__(self, loader, trainer=None, stop_after=None):
        self.loader, self.trainer, self.stop_after = loader, trainer, stop_after
        self.digests, self.times, self.shapes, self.real_rows, self.fillers = [], [], [], [], []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def set_start_batch(self, batch):
        self.loader.set_start_batch(batch)

    def __iter__(self):
        for batch in self.loader:
            self.digests.append(batch_digest(batch))
            self.times.append(time.perf_counter())
            mask = np.asarray(batch.node_mask)
            self.shapes.append((batch.num_nodes, batch.num_edges))
            self.real_rows.append(int(mask.sum()))
            self.fillers.append(int((mask.reshape(self.loader.batch_size, -1).sum(axis=1) == 0).sum()))
            if self.trainer is not None and len(self.digests) == self.stop_after:
                self.trainer.request_interrupt()
            yield batch


def update_rel_errs(params, params_a, start):
    """Per parameter, ||P - A|| / ||A - start||: how far ``params`` are
    from run A's over how far A moved them. The round-off-only leaves
    (``ROUNDOFF_LEAVES``) are left out and their largest absolute
    difference returned apart. Returns (rel by name, that difference)."""
    rel, roundoff = {}, 0.0
    for name, a in params_a.items():
        p, a, s0 = params[name].double(), a.double(), start[name].double()
        if name.endswith(ROUNDOFF_LEAVES):
            roundoff = max(roundoff, (p - a).abs().max().item())
        else:
            rel[name] = ((p - a).norm() / (a - s0).norm()).item()
    return rel, roundoff


def resume_runs(name, param, train_ds, val_ds, counts, expected, seed, tmp, worst_rtol):
    """Steps 1-2 of ``checkpoint_roundtrip`` in ``tmp``: runs A, A' (A again,
    the card's round-off floor), B (interrupted after batch 2) and C (B
    resumed). Returns (readings, run C, its checkpoint's path)."""
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer, load_metadata

    def trainer(run):
        return Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda",
                       checkpoint_dir=f"{tmp}/{run}", metrics_path=f"{tmp}/{run}.csv",
                       rollout_dir=None, save_every_n_steps=1)

    def loader():
        return GraphLoader(train_ds, batch_size=8, shuffle=True, seed=seed)

    fit = dict(val_dataset=val_ds, num_epochs=2, val_trajectories=1)
    for fn in counts.values():
        fn.launches = 0
    run_a = trainer("a")
    loader_a = RecordingLoader(loader())
    total_steps = 2 * len(loader_a)
    run_a.init_state(total_steps)
    start = {k: v.detach().clone() for k, v in run_a.sim.named_parameters()}
    t0 = time.perf_counter()
    history_a = run_a.fit(loader_a, **fit)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    rerun = trainer("a2")
    rerun.fit(RecordingLoader(loader()), **fit)

    run_b = trainer("b")
    loader_b = RecordingLoader(loader(), trainer=run_b, stop_after=2)
    if not run_b.fit(loader_b, **fit)["interrupted"]:
        raise AssertionError(f"{name}: run B was not interrupted")
    ckpt = f"{tmp}/b/state.pt"
    meta = load_metadata(ckpt)
    if (meta["epoch"], meta["batch_offset"], meta["step"]) != (0, 2, 2):
        raise AssertionError(f"{name}: interrupted checkpoint metadata {meta}")
    run_c = trainer("b")
    loader_c = RecordingLoader(loader())
    history_c = run_c.fit(loader_c, resume_from=ckpt, **fit)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counts.items()}
    steps = 2 * run_a.step + run_b.step + run_c.step - 2  # A, A', B, C
    frames = 6 * val_ds.frames_per_trajectory  # validations: A 2, A' 2, B 0, C 2
    want = {k: expected.get(k, (0, 0))[0] * steps + expected.get(k, (0, 0))[1] * frames
            for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")

    lr_a, lr_c = (t.optimizer.param_groups[0]["lr"] for t in (run_a, run_c))
    exact = {
        "step": run_c.step == run_a.step == total_steps,
        "scheduler_position": run_c.scheduler.last_epoch == run_a.scheduler.last_epoch,
        "lr": lr_c == lr_a,
        "batch_stream": (loader_b.digests + loader_c.digests == loader_a.digests
                         and len(loader_a.digests) == total_steps),
    }
    if not all(exact.values()):
        raise AssertionError(f"{name}: the resumed run differs from run A: {exact}, "
                             f"steps {run_c.step} / {run_a.step}, lr {lr_c} / {lr_a}")
    params_a = {k: v.detach() for k, v in run_a.sim.named_parameters()}
    rel, roundoff = update_rel_errs(
        {k: v.detach() for k, v in run_c.sim.named_parameters()}, params_a, start)
    rel_rerun, roundoff_rerun = update_rel_errs(
        {k: v.detach() for k, v in rerun.sim.named_parameters()}, params_a, start)
    roundoff_atol = 2 * ADAM_STEP_MAX * sum(run_a.schedule(i) for i in range(total_steps))
    worst = max(rel, key=rel.get)
    median = float(np.median(list(rel.values())))
    if not (median <= RESUME_MEDIAN_RTOL and rel[worst] <= worst_rtol and roundoff <= roundoff_atol):
        raise AssertionError(
            f"{name}: resumed parameters off by {median} relative (median), {rel[worst]} ({worst}),"
            f" round-off leaves by {roundoff} (limits {RESUME_MEDIAN_RTOL}, {worst_rtol}, "
            f"{roundoff_atol})")
    history = history_a["train_loss"] + history_a["val_rmse"] + history_c["val_rmse"]
    if not all(math.isfinite(v) for v in history):
        raise AssertionError(f"{name}: non-finite history {history_a} {history_c}")
    readings = {
        "dataset_items": len(train_ds),
        "steps_per_run": {"a": run_a.step, "b": run_b.step, "c": run_c.step},
        "resume_exact": exact,
        "final_step": run_c.step,
        "final_lr": lr_c,
        "resume_param_rel_err_worst": rel[worst],
        "resume_worst_param": worst,
        "resume_param_rel_err_median": median,
        "resume_roundoff_leaf_max_abs_diff": roundoff,
        "rerun_param_rel_err_worst": max(rel_rerun.values()),
        "rerun_worst_param": max(rel_rerun, key=rel_rerun.get),
        "rerun_param_rel_err_median": float(np.median(list(rel_rerun.values()))),
        "rerun_roundoff_leaf_max_abs_diff": roundoff_rerun,
        "resume_tolerance": {"median_rtol": RESUME_MEDIAN_RTOL, "worst_rtol": worst_rtol,
                             "roundoff_leaf_atol": roundoff_atol},
        "launches": launches,
        "train_loss": history_a["train_loss"],
        "val_rmse": history_a["val_rmse"],
        "fit_s": fit_s,
    }
    return readings, run_c, ckpt


def checkpoint_roundtrip(name, param, make_traj, counts, expected, frame_kernel, seed, worst_rtol):
    """Checkpoints, resume and ``predict`` on the card, on in-memory
    trajectories (``memory_datasets``, ``CKPT_TRAJECTORIES`` of them,
    batches of 8 frames):

    1. run A: ``Trainer.fit`` for 2 epochs with rollout validation, saving
       every step, and run A' the same again;
    2. run B: the same, ``request_interrupt()`` after batch 2, then run C:
       ``fit(resume_from=)`` B's checkpoint. C's step counter, learning rate
       and batch stream equal A's exactly; its parameters' distances from
       A's, relative to how far A moved them, within ``RESUME_MEDIAN_RTOL``
       (median) and ``worst_rtol`` (worst; A' against A is reported beside
       them); ``expected`` gives (launches per
       step, launches per validated frame) over A, A', B and C together;
    3. the final checkpoint loaded into a fresh ``Trainer`` on the card:
       parameters and normalizer statistics equal the file's and C's;
    4. ``predict(save_dir=None)`` from it on the card: ``BLOCKS`` launches of
       ``frame_kernel`` per frame, equal to C's own predictions, and within
       ``ROLLOUT_ATOL``/``ROLLOUT_RTOL`` of ``predict`` on the CPU from the
       same file over ``CPU_FRAMES``;
    5. the checkpoint's bytes, save and load seconds, predict's ms per
       frame."""
    import tempfile

    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.training import Trainer, load_checkpoint

    blocks = param["model"]["message_passing_num"]
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = memory_datasets(param, make_traj, seed, tmp, n_traj=CKPT_TRAJECTORIES)
        readings, run_c, final = resume_runs(name, param, train_ds, val_ds, counts, expected, seed,
                                             tmp, worst_rtol)

        # 3. save, then load into a fresh trainer on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_c.save(1)
        save_s = time.perf_counter() - t0
        fresh = Trainer(param, seed=seed + 1, device="cuda", metrics_path=None, rollout_dir=None)
        fresh.init_state(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint(final, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.load(final, map_location="cpu", weights_only=True)
        file_load_s = time.perf_counter() - t0
        saved = torch.load(final, map_location="cpu", weights_only=True)["model"]
        live = run_c.sim.state_dict()
        loaded = fresh.sim.state_dict()
        if saved.keys() != loaded.keys():
            raise AssertionError(f"{name}: checkpoint keys differ from the model's")
        for key, value in loaded.items():
            if not (torch.equal(value.cpu(), saved[key]) and torch.equal(value, live[key])):
                raise AssertionError(f"{name}: reloaded {key} differs from the saved one")
        buffers = sum(1 for k in loaded if "_normalizer." in k)

        # 4. predict on the card from the loaded checkpoint
        n_frames = val_ds.frames_per_trajectory
        t0 = time.perf_counter()
        stack_graphs([val_ds[i] for i in val_ds.trajectory_indices(0)])
        host_s = time.perf_counter() - t0
        fresh.predict(val_ds, save_dir=None, max_trajectories=1)  # warm-up
        torch.cuda.synchronize()
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        preds = fresh.predict(val_ds, save_dir=None, max_trajectories=1)[0]
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        predict_launches = {k: fn.launches for k, fn in counts.items()}
        want = {k: (blocks * n_frames if k == frame_kernel else 0) for k in counts}
        if predict_launches != want:
            raise AssertionError(f"{name}: predict launches {predict_launches}, expected {want}")
        width = param["index"]["output_index_end"] - param["index"]["output_index_start"]
        if preds.shape != (n_frames, val_ds.node_budget, width) or not np.isfinite(preds).all():
            raise AssertionError(f"{name}: bad predictions {preds.shape}")
        in_memory = run_c.predict(val_ds, save_dir=None, max_trajectories=1)[0]
        memory_diff = float(np.abs(preds - in_memory).max())
        if memory_diff != 0.0:
            raise AssertionError(f"{name}: loaded model predicts {memory_diff} off the trained one")
        cpu = Trainer(param, seed=seed + 1, device="cpu", metrics_path=None, rollout_dir=None)
        cpu.init_state(1)
        load_checkpoint(final, cpu.sim)
        preds_cpu = cpu.predict(val_ds, save_dir=None, max_trajectories=1)[0][:CPU_FRAMES]
        cpu_err = float(np.abs(preds[:CPU_FRAMES] - preds_cpu).max())
        if not np.allclose(preds[:CPU_FRAMES], preds_cpu, rtol=ROLLOUT_RTOL, atol=ROLLOUT_ATOL):
            raise AssertionError(f"{name}: card vs CPU predict max_abs_err {cpu_err}")
        size = os.path.getsize(final)
    return {
        **readings,
        "checkpoint_bytes": size,
        "save_s": save_s,
        "load_s": load_s,
        "load_file_s": file_load_s,
        "reload_bitwise": True,
        "reloaded_tensors": len(loaded),
        "reloaded_normalizer_buffers": buffers,
        "predict_frames": n_frames,
        "predict_launches": predict_launches,
        "predict_ms_per_frame": predict_s / n_frames * 1e3,
        "host_frames_ms_per_frame": host_s / n_frames * 1e3,
        "predict_vs_in_memory_max_abs_diff": memory_diff,
        "cpu_frames_checked": CPU_FRAMES,
        "cpu_max_abs_err": cpu_err,
        "cpu_rtol": ROLLOUT_RTOL,
        "cpu_atol": ROLLOUT_ATOL,
    }


def kernel_counters() -> dict:
    """Every kernel entry's launch counter by name (each has ``.launches``),
    and ``gather_csr``'s count of transposed CSRs built."""
    from graphphysics_torch.ops.csr_attention import (
        csr_attention,
        csr_attention_backward,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
        csr_softmax_spmm_pair,
        csr_softmax_spmm_pair_backward,
        gather_csr,
    )
    from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_backward

    return {
        "csr_segment_sum": csr_segment_sum,
        "csr_segment_sum_backward": csr_segment_sum_backward,
        "csr_softmax_spmm": csr_softmax_spmm,
        "csr_softmax_spmm_backward": csr_softmax_spmm_backward,
        "csr_attention": csr_attention,
        "csr_attention_backward": csr_attention_backward,
        "csr_attention_bf16": csr_attention.bf16,
        "csr_attention_backward_bf16": csr_attention_backward.bf16,
        "csr_softmax_spmm_pair": csr_softmax_spmm_pair,
        "csr_softmax_spmm_pair_backward": csr_softmax_spmm_pair_backward,
        # the 16-bit entries of K1 and K1b and the bf16 stream's entries
        "csr_segment_sum_bf16": csr_segment_sum.bf16,
        "csr_segment_sum_f16": csr_segment_sum.f16,
        "csr_segment_sum_backward_bf16": csr_segment_sum_backward.bf16,
        "csr_segment_sum_backward_f16": csr_segment_sum_backward.f16,
        "csr_softmax_spmm_bf16_stream": csr_softmax_spmm.bf16_stream,
        "csr_softmax_spmm_pair_bf16_stream": csr_softmax_spmm_pair.bf16_stream,
        "csr_attention_f32_stream": csr_attention.f32_stream,
        "csr_attention_bf16_stream": csr_attention.bf16_stream,
        # not a kernel: the transposed CSR of the bf16 backward, built by
        # PyTorch ops once per bf16 training forward on the card
        "gather_csr": gather_csr,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=50)
    parser.add_argument("--aneurysm-grid", type=int, default=ANEURYSM_GRID,
                        help="tet_grid resolution of the XDMF phases: GRID^3 nodes (40 gives "
                             "the 64,000-node mesh the default was cut from)")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no result", file=sys.stderr)
        return 2

    from graphphysics_torch.core import concat_graphs
    from graphphysics_torch.dataset import build_preprocessing
    from graphphysics_torch.ops import _native
    from graphphysics_torch.training import get_preprocessing
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products sum in f32, as on the CPU and in XLA
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = nvidia_smi_line()
    clock = PhaseClock()
    counts = kernel_counters()

    # 1. environment and build: the kernels, and the host C++ beside them ----------
    from concurrent.futures import ThreadPoolExecutor

    from graphphysics_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host_build = pool.submit(native.build)
        build_s = _native.build()
        host_build_s = host_build.result()
    clock.emit({
        "phase": "build",
        "nvidia_smi": smi,
        "device_name": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "build_s": build_s,
        "build_wall_s": time.perf_counter() - t0,
        "libraries": [_native.library_path(s).name for s in _native.SOURCES],
        "host_library": native.library_path().name,
        "host_build_s": host_build_s,
        "tf32": False,
    })
    # 48. the host C++ graph builders against their plain versions
    clock.emit({"phase": "host_native", **host_native()})

    # host side of the two serving paths: trajectories of 2,048 nodes
    epd_frames, epd_sizes = trajectory_frames(
        cylinder_trajectory, args.frames, 2, build_preprocessing(), "sorted"
    )
    panels = load_config(PANELS_CONFIG)
    cylinder = load_config(CYLINDER_CONFIG)
    tf_frames, tf_sizes = trajectory_frames(
        panels_trajectory, args.frames, panels["index"]["node_type_index"],
        get_preprocessing(panels, use_edge_feature=False, remove_noise=True), "csr",
    )
    cyl_graphs, tf_graphs = flagship_graphs(args.seed), panels_graphs(args.seed + 200)
    cyl_batch, tf_batch = concat_graphs(cyl_graphs), concat_graphs(tf_graphs)
    aneurysm_epd = random_graph(*ANEURYSM, args.seed + 100)
    aneurysm_csr = random_csr_graph(*ANEURYSM, args.seed + 300)

    # 2, 7. kernels, forward and backward -------------------------------------------
    k1_shapes = [
        k1_case("serving_frame", epd_frames[0], args.seed),
        k1_case("flagship_batch_8x2048", cyl_batch, args.seed + 1),
        k1_case("aneurysm_epd_66560x524288", aneurysm_epd, args.seed + 2),
    ]
    floor = launch_floor_ms()
    for s in k1_shapes:
        s["launch_floor_ms"] = floor
        s["bound_share"] = s["bound_ms"] / s["ms"]
        s["bound_share_above_floor"] = s["bound_ms"] / max(s["ms"] - floor, 1e-9)
        clock.emit({"phase": "kernel", "name": "csr_segment_sum", **s})
    for record in k1_geometry_cases(cyl_batch, args.seed + 80):
        clock.emit({"phase": "kernel", "name": "geometry", **record})
    for fn in counts.values():
        fn.launches = 0
    # K2 and K3 at the shape their own path runs: part 0 of the unsplit
    # partitioned transformer's 4-way cut of the 16,384-node mesh
    mesh_part = unsplit_part0(args.seed + 601)
    k2_shapes = [
        k2_case("transformer_serving_frame", tf_frames[0], HIDDEN, args.seed + 3),
        k2_case("panels_csr_batch_8x2048", tf_batch, HIDDEN, args.seed + 4),
        k2_case("aneurysm_csr_66560x524288", aneurysm_csr, 64, args.seed + 5),
        k2_case("mesh_16384_part0_of_4_unsplit", mesh_part, HIDDEN, args.seed + 81),
        # the widths JAX takes that needed the general geometry, at the batch
        # and at the unsplit mesh part of the partitioned phases' hidden 48
        *(k2_case(f"panels_csr_batch_8x2048_d{d}_h{h}", tf_batch, d, args.seed + 84 + i, heads=h)
          for i, (d, h) in enumerate(GENERAL_WIDTHS)),
        k2_case("mesh_16384_part0_of_4_unsplit_d48_h4", mesh_part, 48, args.seed + 87, heads=4),
        # the shape K2's word geometry runs on its path: the unsplit
        # partitioned transformer at hidden 40 in 8 heads, part 0
        k2_case(MESH_WORD_SHAPE, mesh_part, 40, args.seed + 92, heads=8),
        # the general geometry's: hidden 160 in 5 heads, there and at the batch
        k2_case(MESH_GENERAL_SHAPE, mesh_part, 160, args.seed + 94, heads=5),
        k2_case("panels_csr_batch_8x2048_d160_h5", tf_batch, 160, args.seed + 95, heads=5),
    ]
    for s in k2_shapes:
        s["launch_floor_ms"] = floor
        s["bound_share"] = s["bound_ms"] / s["ms"]
        s["bound_share_above_floor"] = s["bound_ms"] / max(s["ms"] - floor, 1e-9)
        clock.emit({"phase": "kernel", "name": "csr_softmax_spmm", **s})
    for record in k2_f32_geometry_cases(tf_batch, args.seed + 83):
        clock.emit({"phase": "kernel", "name": "geometry", **record})
    k1b_shapes = [
        k1b_case("serving_frame", epd_frames[0], args.seed + 6),
        k1b_case("flagship_batch_8x2048", cyl_batch, args.seed + 7),
        k1b_case("aneurysm_epd_66560x524288", aneurysm_epd, args.seed + 8),
    ]
    for s in k1b_shapes:
        clock.emit({"phase": "kernel", "name": "csr_segment_sum_backward", **s})
    k3_shapes = [
        k3_case("transformer_serving_frame", tf_frames[0], HIDDEN, args.seed + 9),
        k3_case("panels_csr_batch_8x2048", tf_batch, HIDDEN, args.seed + 10),
        k3_case("aneurysm_csr_66560x524288", aneurysm_csr, 64, args.seed + 11),
        k3_case("mesh_16384_part0_of_4_unsplit", mesh_part, HIDDEN, args.seed + 82),
        *(k3_case(f"panels_csr_batch_8x2048_d{d}_h{h}", tf_batch, d, args.seed + 88 + i, heads=h)
          for i, (d, h) in enumerate(GENERAL_WIDTHS)),
        k3_case("mesh_16384_part0_of_4_unsplit_d48_h4", mesh_part, 48, args.seed + 91, heads=4),
        k3_case(MESH_WORD_SHAPE, mesh_part, 40, args.seed + 93, heads=8),
        k3_case(MESH_GENERAL_SHAPE, mesh_part, 160, args.seed + 96, heads=5),
        k3_case("panels_csr_batch_8x2048_d160_h5", tf_batch, 160, args.seed + 97, heads=5),
    ]
    for s in k3_shapes:
        clock.emit({"phase": "kernel", "name": "csr_softmax_spmm_backward", **s})
    for record in k3_f32_geometry_cases(tf_batch, args.seed + 83):
        clock.emit({"phase": "kernel", "name": "geometry", **record})
    # K2 and K3 run on no transformer path now: their launches are their
    # kernel phases' (the checks, and each captured call of a timing)
    phase_launches = {k: counts[k].launches for k in ("csr_softmax_spmm", "csr_softmax_spmm_backward")}
    # 50. the two 16-bit stream modes: their kernels, then their path
    from chip_stream import stream_phase

    streams, stream_path = stream_phase(clock, counts, args.seed + 70, epd_frames[0], cyl_batch, aneurysm_epd,
                                        tf_frames[0], tf_batch, aneurysm_csr)
    fused = [
        fused_case("transformer_serving_frame", tf_frames[0], HIDDEN, args.seed + 12),
        fused_case("panels_csr_batch_8x2048", tf_batch, HIDDEN, args.seed + 13),
        fused_case("aneurysm_csr_66560x524288", aneurysm_csr, 64, args.seed + 14, library=False),
    ]
    fused_shapes, fused_bwd_shapes = [f for f, _ in fused], [b for _, b in fused]
    for s in fused_shapes:
        clock.emit({"phase": "kernel", "name": "csr_attention", **s})
    for s in fused_bwd_shapes:
        clock.emit({"phase": "kernel", "name": "csr_attention_backward", **s})
    del aneurysm_epd
    # 11. widths without a power-of-two head split: the word geometry in the
    # model's view (and at 96 x 3 contiguous), beside SDPA in that view
    widths = [
        fused_case(f"panels_csr_batch_8x2048_d{d}_h{h}_{view}", tf_batch, d, args.seed + 15 + i,
                   library=view == "model", heads=h, view=view, replaced=False)
        for i, ((d, h), view) in enumerate((w, v) for w in GENERAL_WIDTHS for v in ("model", "contiguous"))
    ]
    # a width past the f32 word geometry's 32 lanes: the general code of
    # csr_attention.cuh
    d, h, view = F32_GENERAL_CASE
    general = fused_case(f"panels_csr_batch_8x2048_d{d}_h{h}_{view}", tf_batch, d, args.seed + 21,
                         library=False, heads=h, view=view, replaced=False)
    if {*general[0]["geometry"].values(), *general[1]["geometry"].values()} != {"general"}:
        raise AssertionError(f"{general[0]['shape']}: ran {general[0]['geometry']}, not the general geometry")
    widths.append(general)
    for s, _ in widths:
        clock.emit({"phase": "kernel_width", "name": "csr_attention", **s})
    for _, s in widths:
        clock.emit({"phase": "kernel_width", "name": "csr_attention_backward", **s})
    fused_shapes += [f for f, _ in widths]
    fused_bwd_shapes += [b for _, b in widths]
    # 47. the tensor-parallel ranks' local widths, interleaved, f32 and bf16
    tp_widths = [fused_case(f"panels_csr_batch_8x2048_d{d}_h{h}_tp_local", tf_batch, d,
                            args.seed + 60 + i, library=False, heads=h, replaced=False)
                 for i, (d, h) in enumerate(TP_LOCAL_WIDTHS)]
    tp_bf16_widths = [fused_bf16_case(f"panels_csr_batch_8x2048_d{d}_h{h}_tp_local", tf_batch, d,
                                      args.seed + 62 + i, heads=h, library=False)
                      for i, (d, h) in enumerate(TP_LOCAL_WIDTHS)]
    for name, cases in (("csr_attention", tp_widths), ("csr_attention_bf16", tp_bf16_widths)):
        for f, b in cases:
            clock.emit({"phase": "kernel_width", "name": name, "tensor_parallel_local": True, **f})
            clock.emit({"phase": "kernel_width", "name": name.replace("attention", "attention_backward"),
                        "tensor_parallel_local": True, **b})
    fused_shapes += [f for f, _ in tp_widths]
    fused_bwd_shapes += [b for _, b in tp_widths]
    # 18, 27. the bf16 fused kernels and K5: the last kernels timed, before a
    # second process shares the card
    from chip_partition import k5_phase

    bf16_kernels = bf16_kernel_cases(clock, args.seed, tf_frames, tf_batch, aneurysm_csr)
    k5_shapes, k5_bwd_shapes = k5_phase(clock, args.seed, tf_frames, aneurysm_csr, floor)
    del aneurysm_csr
    torch.cuda.empty_cache()

    # 17, 27-31, 38-46. the short fidelity runs and every phase that starts
    # ranks, in a second process beside the phases below (its lines are
    # printed when it ends, each with the seconds it took there): partitioned
    # training, rollouts and the CLI's fit on 4 ranks sharing the card, the
    # data-parallel steps on 2 and on 2 x 2, tensor and pipeline parallelism
    # on 2 and 3, the partitioned serving export on 2
    import atexit
    import tempfile

    from chip_parallel import finish_multirank, start_multirank, stop_multirank

    multirank_tmp = tempfile.TemporaryDirectory(prefix="multirank_", ignore_cleanup_errors=True)
    multirank = start_multirank(multirank_tmp.name, args.seed, cylinder, panels, epd_frames, tf_frames,
                                FIDELITY_CONFIGS)
    atexit.register(stop_multirank, multirank)  # after a failure here: stop it and its ranks

    # 3-4. EPD: serving rollout and batched forward --------------------------------
    epd, result, profile_line = serve(
        "epd_serving", build_epd, epd_frames, counts, {"csr_segment_sum": BLOCKS}, args.seed
    )
    check_k1_words("epd_serving", result)
    clock.emit({"phase": "serving", "model": f"EncodeProcessDecode {BLOCKS}x{HIDDEN}, cylinder",
          **epd_sizes, **result})
    clock.emit({"phase": "serving_profile", "model": "EncodeProcessDecode", **profile_line})
    clock.emit({"phase": "batched", "model": "EncodeProcessDecode", **batched_forward(
        "epd_batched", epd, cyl_batch.to("cuda"), counts, {"csr_segment_sum": BLOCKS})})
    del epd

    # 5-6. transformer: serving rollout and batched forward ------------------------
    blocks = panels["model"]["message_passing_num"]
    tf_model = (f"EncodeTransformDecode {blocks}x{panels['model']['hidden_size']}, "
                f"{panels['model']['num_heads']} heads, {PANELS_CONFIG}")
    tf, result, profile_line = serve(
        "transformer_serving", lambda seed, dev: build_transformer(panels, seed, dev),
        tf_frames, counts, {"csr_attention": blocks}, args.seed,
    )
    clock.emit({"phase": "transformer_serving", "model": tf_model, **tf_sizes, **result})
    clock.emit({"phase": "transformer_serving_profile", "model": "EncodeTransformDecode", **profile_line})
    clock.emit({"phase": "transformer_batched", "model": "EncodeTransformDecode", **batched_forward(
        "transformer_batched", tf, tf_batch.to("cuda"), counts, {"csr_attention": blocks})})
    del tf

    # 8. training: the main path of this slice ---------------------------------------
    epd_blocks = cylinder["model"]["message_passing_num"]
    epd_train = train("epd_training", cylinder, cyl_batch, counts,
                      {"csr_segment_sum": epd_blocks, "csr_segment_sum_backward": epd_blocks},
                      args.seed, EPD_GRAD_RTOL)
    check_k1_words("epd_training", epd_train)
    clock.emit({"phase": "epd_training",
          "model": f"EncodeProcessDecode {epd_blocks}x{cylinder['model']['hidden_size']}, "
                   f"{CYLINDER_CONFIG}", **epd_train})
    tf_train = train("transformer_training", panels, tf_batch, counts,
                     {"csr_attention": blocks, "csr_attention_backward": blocks}, args.seed,
                     TRANSFORMER_GRAD_RTOL)
    clock.emit({"phase": "transformer_training", "model": tf_model, **tf_train})

    # 9. training pipeline: dataset, loader, fit with validation --------------------
    clock.emit({"phase": "epd_pipeline", **pipeline(
        "epd_pipeline", cylinder, cylinder_trajectory, counts,
        {"csr_segment_sum": (epd_blocks, epd_blocks), "csr_segment_sum_backward": (epd_blocks, 0)},
        args.seed)})
    clock.emit({"phase": "transformer_pipeline", **pipeline(
        "transformer_pipeline", panels, panels_trajectory, counts,
        {"csr_attention": (blocks, blocks), "csr_attention_backward": (blocks, 0)},
        args.seed)})

    # 10. checkpoints, resume and predict on the card ------------------------------
    clock.emit({"phase": "epd_checkpoint", **checkpoint_roundtrip(
        "epd_checkpoint", cylinder, cylinder_trajectory, counts,
        {"csr_segment_sum": (epd_blocks, epd_blocks), "csr_segment_sum_backward": (epd_blocks, 0)},
        "csr_segment_sum", args.seed, EPD_RESUME_WORST_RTOL)})
    clock.emit({"phase": "transformer_checkpoint", **checkpoint_roundtrip(
        "transformer_checkpoint", panels, panels_trajectory, counts,
        {"csr_attention": (blocks, blocks), "csr_attention_backward": (blocks, 0)},
        "csr_attention", args.seed, TRANSFORMER_RESUME_WORST_RTOL)})

    # 11. the first train step of the panels transformer at a width without
    # a fast geometry (the word geometry's), against the CPU; then that
    # transformer trained and served, its fused kernels all in the word
    # geometry, beside the 128 x 4 step
    total_steps = 1 + WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS
    panels48 = load_config(PANELS_CONFIG)
    panels48["model"]["hidden_size"] = 48
    width_model = (f"EncodeTransformDecode {blocks}x48, {panels['model']['num_heads']} heads, "
                   f"{PANELS_CONFIG} with hidden_size 48")
    width_first = first_step("width_first_step", panels48, tf_batch, args.seed, total_steps,
                             TRANSFORMER_GRAD_RTOL)
    clock.emit({"phase": "width_first_step", "model": width_model, **width_first})
    width_train = width_training(panels48, tf_batch, tf_frames[0], counts, blocks, args.seed, width_first,
                                 tf_train)
    clock.emit({"phase": "width_training", "model": width_model, **width_train})

    # 12. GMM training: c-a-gmm at the aneurysm scale --------------------------------
    gmm = load_config(GMM_CONFIG)
    gmm_blocks = gmm["model"]["message_passing_num"]
    gmm_model = (f"EncodeTransformDecode {gmm_blocks}x{gmm['model']['hidden_size']}, "
                 f"{gmm['model']['num_heads']} heads, K={gmm['model']['num_mixture_components']} "
                 f"diagonal GMM head, {GMM_CONFIG}")
    gmm_graph = aneurysm_gmm_graph(args.seed + 400)
    gmm_train = train("gmm_training", gmm, gmm_graph, counts,
                      {"csr_attention": gmm_blocks, "csr_attention_backward": gmm_blocks}, args.seed,
                      TRANSFORMER_GRAD_RTOL, graphs=1)
    full = dict(gmm, model=dict(gmm["model"], use_diagonal=False))
    gmm_train["full_covariance"] = first_step("gmm_training_full_covariance", full, gmm_graph, args.seed,
                                              total_steps, TRANSFORMER_GRAD_RTOL)
    clock.emit({"phase": "gmm_training", "model": gmm_model, **gmm_train})
    del gmm_graph

    # 13. GMM serving: a sampled rollout at the aneurysm scale ------------------------
    gmm_frames = gmm_trajectory(args.seed + 500, args.frames)
    clock.emit({"phase": "gmm_serving", "model": gmm_model,
          **gmm_serving("gmm_serving", gmm, gmm_frames, counts, args.seed)})
    del gmm_frames

    # 14. GMM pipeline: panels with a K = 3 head, fit, reload, predict ---------------
    panels_gmm = load_config(PANELS_CONFIG)
    panels_gmm["model"]["num_mixture_components"] = 3
    clock.emit({"phase": "gmm_pipeline", "model": f"{PANELS_CONFIG} with num_mixture_components 3",
          **gmm_pipeline("gmm_pipeline", panels_gmm, panels_trajectory, counts, args.seed)})

    # 15. the XDMF path: both aneurysm configs from their own inline files ----------
    from graphphysics_torch.topology import cells_to_edges
    from graphphysics_torch.utils.synthetic import tet_grid

    aneurysm_paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        grid = args.aneurysm_grid
        folders, write_s = aneurysm_folders(tmp, grid)
        tets = tet_grid(grid)[1]
        sizes = {"grid": grid, "nodes": grid ** 3, "tetrahedra": len(tets),
                 "directed_edges": len(cells_to_edges(tets)[0]), "frames": ANEURYSM_FRAMES,
                 "train_trajectories": ANEURYSM_TRAJECTORIES,
                 "held_out_trajectories": ANEURYSM_HELD_OUT, "inline_write_s": write_s}
        for path in ANEURYSM_CONFIGS:
            param = load_config(path)
            label = f"aneurysm_xdmf_pipeline:{os.path.basename(path)}"
            result = aneurysm_pipeline(label, param, folders, counts, args.seed)
            if (result["nodes"], result["real_edges"]) != (sizes["nodes"], sizes["directed_edges"]):
                raise AssertionError(f"{label}: graph of {result['nodes']} nodes and "
                                     f"{result['real_edges']} edges, expected {sizes}")
            aneurysm_paths[label] = result
            clock.emit({"phase": "aneurysm_xdmf_pipeline", "config": path, **sizes, **result})

    # 16. the plate pipeline: plate.json, world edges, the worker loader -----------
    plate = load_config(PLATE_CONFIG)
    plate_blocks = plate["model"]["message_passing_num"]
    plate_model = (f"EncodeTransformDecode {plate_blocks}x{plate['model']['hidden_size']}, "
                   f"{plate['model']['num_heads']} heads, {PLATE_CONFIG}")
    plate_result = plate_pipeline("plate_pipeline", plate, counts, args.seed, PLATE_WORKERS)
    clock.emit({"phase": "plate_pipeline", "model": plate_model,
                "mesh": f"tet_box({PLATE_GRID[0]}, {PLATE_GRID[0]}, {PLATE_GRID[1]}) and the punch",
                **plate_result})

    # 19-22. bf16 training, bf16 serving, remat, the large mesh ------------------------
    bf16_paths = bf16_phases(clock, counts, args.seed, epd_frames, tf_frames, tf_batch, cyl_batch, panels,
                             cylinder, epd_train, tf_train, gmm_train)
    torch.cuda.empty_cache()
    # 51. the bf16 transformer at a width of the bf16 word geometry: 48 in 4
    # heads, its first step against the CPU in bf16 on one 2,048-node graph
    check_csr = random_csr_graph(BATCH_NODES[1], BATCH_EDGES[1], 2048, 12288, args.seed + 51)
    bf16_paths["bf16_width_training"] = bf16_width_training(
        panels48, tf_batch, check_csr, tf_frames[0], counts, blocks, args.seed, width_train,
        bf16_paths["bf16_transformer_training"])
    clock.emit({"phase": "bf16_width_training", "model": f"{width_model}, bf16",
                **bf16_paths["bf16_width_training"]})

    # 23-26. gradient accumulation, the ELL layout, size buckets, project_before_gather
    feature_paths = training_feature_phases(clock, counts, args.seed, cylinder, panels, cyl_graphs, tf_graphs)

    # 32-37. the serving artifacts (torch.export of the kernels' ops), the
    # directory checkpoints, determinism, the profiler, the build cache, the doctor
    from chip_utilities import utility_phases

    export_paths = utility_phases(clock, counts, args.seed, epd_frames, tf_frames, cyl_batch, tf_batch,
                                  cylinder, panels)
    multirank_paths = finish_multirank(multirank)
    multirank_tmp.cleanup()

    def entry(name, source, replaces, launches, shapes, tolerance, main_shape=1, **extra):
        main = shapes[main_shape]  # the 8 x 2,048 batch: the training path's shape
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches,
            "max_abs_err": main["max_abs_err"],
            "tolerance": tolerance,
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "shape": main["shape"],
            **extra,
            "shapes": shapes,
        }

    # launches of the training paths, each counted from 0 over its timed
    # steps, of the XDMF and plate pipelines (timed steps, fits and predict,
    # each counted from 0) and of the short fidelity runs
    paths = {"epd_training": epd_train, "transformer_training": tf_train, "gmm_training": gmm_train,
             **aneurysm_paths, "plate_pipeline": plate_result, **bf16_paths, **feature_paths,
             **multirank_paths, **export_paths, "stream_dtypes": stream_path}
    launched = {k: sum(r["launches"].get(k, 0) for r in paths.values()) for k in counts}
    by_path = {k: {p: r["launches"].get(k, 0) for p, r in paths.items() if r["launches"].get(k, 0)}
               for k in counts}
    partitioned = {"launches_from": "the unsplit partitioned transformer's timed steps, 4 ranks "
                                    "(partitioned_transformer_training); the unpartitioned "
                                    "models run the fused kernels"}
    kernels = {"kernels": [
        entry("csr_segment_sum", "graphphysics_torch/csrc/csr_segment_sum.cu",
              "graphphysics_tpu/ops/pallas_segment.py:148", launched["csr_segment_sum"], k1_shapes,
              KERNEL_ATOL, launches_by_path=by_path["csr_segment_sum"], launch_floor_ms=floor),
        entry("csr_segment_sum_backward", "graphphysics_torch/csrc/csr_segment_sum.cu",
              "graphphysics_tpu/ops/pallas_segment.py:228", launched["csr_segment_sum_backward"],
              k1b_shapes, GATHER_ATOL, launches_by_path=by_path["csr_segment_sum_backward"]),
        entry("csr_softmax_spmm", "graphphysics_torch/csrc/csr_softmax_spmm.cu",
              "graphphysics_tpu/ops/pallas_attention.py:255", launched["csr_softmax_spmm"],
              k2_shapes, {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL}, **partitioned,
              launches_by_path=by_path["csr_softmax_spmm"], kernel_phase_launches=phase_launches[
                  "csr_softmax_spmm"], launch_floor_ms=floor),
        entry("csr_softmax_spmm_backward", "graphphysics_torch/csrc/csr_softmax_spmm_bwd.cu",
              "graphphysics_tpu/ops/pallas_attention.py:398", launched["csr_softmax_spmm_backward"],
              k3_shapes, {"rtol": K3_RTOL, "atol": K3_ATOL}, **partitioned,
              launches_by_path=by_path["csr_softmax_spmm_backward"],
              kernel_phase_launches=phase_launches["csr_softmax_spmm_backward"]),
        entry("csr_softmax_spmm_pair", "graphphysics_torch/csrc/csr_softmax_spmm_pair.cu",
              "graphphysics_tpu/ops/pallas_attention.py:495", launched["csr_softmax_spmm_pair"],
              k5_shapes, {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL},
              replaced_ms=k5_shapes[1]["replaced_ms"], launch_floor_ms=floor,
              launches_by_path=by_path["csr_softmax_spmm_pair"],
              also_replaces="graphphysics_tpu/ops/pallas_attention.py:460 (_pair_impl) and :255 "
                            "(_softmax_spmm_impl, launched twice by it)"),
        entry("csr_softmax_spmm_pair_backward", "graphphysics_torch/csrc/csr_softmax_spmm_pair.cu",
              "graphphysics_tpu/ops/pallas_attention.py:544", launched["csr_softmax_spmm_pair_backward"],
              k5_bwd_shapes, {"rtol": K3_GRAD_RTOL, "atol": K3_GRAD_ATOL},
              replaced_ms=k5_bwd_shapes[1]["replaced_ms"], launch_floor_ms=floor,
              launches_by_path=by_path["csr_softmax_spmm_pair_backward"],
              also_replaces="_pack_node_side and _edge_grads (graphphysics_tpu/ops/pallas_attention.py"
                            ":418, :433) of _pair_bwd"),
        entry("csr_attention", "graphphysics_torch/csrc/csr_attention.cu",
              "graphphysics_tpu/ops/pallas_attention.py:255", launched["csr_attention"], fused_shapes,
              {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL}, replaced_ms=fused_shapes[1]["replaced_ms"],
              launches_by_path=by_path["csr_attention"],
              also_replaces="graphphysics_tpu/ops/pallas_attention.py:556 (csr_sparse_attention's "
                            "gathers and SDDMM)"),
        entry("csr_attention_backward", "graphphysics_torch/csrc/csr_attention_bwd.cu",
              "graphphysics_tpu/ops/pallas_attention.py:398", launched["csr_attention_backward"],
              fused_bwd_shapes, {"rtol": K3_GRAD_RTOL, "atol": K3_GRAD_ATOL},
              replaced_ms=fused_bwd_shapes[1]["replaced_ms"],
              launches_by_path=by_path["csr_attention_backward"],
              also_replaces="the backward of csr_sparse_attention's gathers and SDDMM "
                            "(graphphysics_tpu/ops/pallas_attention.py:556)"),
        entry("csr_attention_bf16", "graphphysics_torch/csrc/csr_attention_bf16.cu",
              "graphphysics_tpu/ops/pallas_attention.py:255", launched["csr_attention_bf16"],
              [f for f, _ in bf16_kernels + tp_bf16_widths], {"rtol": BF16_KERNEL_RTOL, "atol": BF16_KERNEL_ATOL},
              f32_entry_ms=bf16_kernels[1][0]["f32_entry_ms"], launches_by_path=by_path["csr_attention_bf16"],
              also_replaces="graphphysics_tpu/ops/pallas_attention.py:556 (csr_sparse_attention's "
                            "gathers and SDDMM) on bf16 q, k, v"),
        entry("csr_attention_backward_bf16", "graphphysics_torch/csrc/csr_attention_bwd_bf16.cu",
              "graphphysics_tpu/ops/pallas_attention.py:398", launched["csr_attention_backward_bf16"],
              [b for _, b in bf16_kernels + tp_bf16_widths], {"rtol": BF16_KERNEL_RTOL, "atol": BF16_KERNEL_ATOL},
              f32_entry_ms=bf16_kernels[1][1]["f32_entry_ms"],
              transpose_ms=bf16_kernels[1][1]["transpose_ms"], transpose_builds=launched["gather_csr"],
              launches_by_path=by_path["csr_attention_backward_bf16"],
              also_replaces="the backward of csr_sparse_attention's gathers and SDDMM on bf16 q, k, v"),
    ]}
    # K2's and K3's word geometry (forward_words, backward_words) and their
    # general geometry (softmax_general.cuh), each with its launches counted
    # by geometry on the unsplit partitioned transformer at the widths that
    # take it: the words K2's at hidden 40 in 8 heads of 5 (at 48 its
    # 16-byte words of one head run), K3's at 48 and at 40; the general
    # geometry both at 160 in 5 heads; each entry's time, bound and error at
    # its path's own shape (part 0 of the mesh cut)
    unsplit = {d: f"partitioned_transformer_training:transformer_unsplit_w{d}" for d in (48, 40, 160)}

    def unsplit_launches(name, kind, widths_):
        return {unsplit[d]: multirank_paths[unsplit[d]]["launches"].get(f"{name}:{kind}", 0) for d in widths_}

    by_kind = {("csr_softmax_spmm", "words"): unsplit_launches("csr_softmax_spmm", "words", (40,)),
               ("csr_softmax_spmm_backward", "words"): unsplit_launches("csr_softmax_spmm_backward", "words",
                                                                        (48, 40)),
               ("csr_softmax_spmm", "general"): unsplit_launches("csr_softmax_spmm", "general", (160,)),
               ("csr_softmax_spmm_backward", "general"): unsplit_launches("csr_softmax_spmm_backward", "general",
                                                                          (160,))}
    shapes_of = {(name, kind): [r for r in rs if r["kind"] == kind]
                 for name, rs in (("csr_softmax_spmm", k2_shapes), ("csr_softmax_spmm_backward", k3_shapes))
                 for kind in ("words", "general")}
    main = {key: next((i for i, r in enumerate(shapes_of[key])
                       if r["shape"] == (MESH_WORD_SHAPE if key[1] == "words" else MESH_GENERAL_SHAPE)), None)
            for key in by_kind}
    if not (all(all(v.values()) for v in by_kind.values()) and None not in main.values()):
        raise AssertionError(f"K2's and K3's words and general geometry: launches {by_kind} on the unsplit "
                             f"partitioned paths, {MESH_WORD_SHAPE} and {MESH_GENERAL_SHAPE} among the timed "
                             f"shapes {main}")
    sources = {"csr_softmax_spmm": ("graphphysics_torch/csrc/csr_softmax_spmm.cu",
                                    "graphphysics_tpu/ops/pallas_attention.py:255",
                                    {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL}, "csr_softmax_spmm_f32"),
               "csr_softmax_spmm_backward": ("graphphysics_torch/csrc/csr_softmax_spmm_bwd.cu",
                                             "graphphysics_tpu/ops/pallas_attention.py:398",
                                             {"rtol": K3_RTOL, "atol": K3_ATOL}, "csr_softmax_spmm_bwd_f32")}
    notes = {
        ("csr_softmax_spmm", "words"): "K2's word geometry: one 16-byte word of 4 columns a lane, which may span "
                                       "heads, each head's online step an edge, 8 edges in flight, no shuffles",
        ("csr_softmax_spmm_backward", "words"): "K3's word geometry: head sums reduce-scattered by shuffles "
                                                "(word_heads.cuh), one weight a head read back by its columns",
        ("csr_softmax_spmm", "general"): "K2's general geometry, K5's on one edge set: past 32 words",
        ("csr_softmax_spmm_backward", "general"): "K3's general geometry: per-head sums over strided columns, "
                                                  "zeros on masked and uncovered edges"}
    for (name, kind), launches_by_path in by_kind.items():
        source, replaces, tolerance, entry_point = sources[name]
        if kind == "general":
            source = "graphphysics_torch/csrc/softmax_general.cuh"
        kernels["kernels"].append(entry(
            f"{name}_{kind}", source, replaces, sum(launches_by_path.values()), shapes_of[name, kind], tolerance,
            main_shape=main[name, kind], launches_by_path=launches_by_path,
            entry_point=f"{entry_point} ({sources[name][0].rsplit('/', 1)[1]})", note=notes[name, kind]))
    # the word geometry of the fused f32 entries (attention_words.cuh), its
    # launches from the transformer at hidden 48 in 4 heads (width_training),
    # its time, bound and error at that path's shape: the batch, model view
    word_launches = width_train["fused_f32_launches_by_geometry"]
    word_cases = [(f, b) for f, b in widths if f["geometry"]["forward"] == "words"]
    word_main = next((i for i, (f, _) in enumerate(word_cases) if f["shape"] == WORD_SHAPE), None)
    if word_main is None or not (word_launches["forward"]["words"] and word_launches["backward"]["words"]):
        raise AssertionError(f"the word geometry: launches {word_launches} on width_training, {WORD_SHAPE} "
                             f"among the timed shapes {[f['shape'] for f, _ in word_cases]}")
    kernels["kernels"] += [
        entry("csr_attention_general", "graphphysics_torch/csrc/attention_words.cuh",
              "graphphysics_tpu/ops/pallas_attention.py:255", word_launches["forward"]["words"],
              [f for f, _ in word_cases], {"rtol": SOFTMAX_RTOL, "atol": SOFTMAX_ATOL}, main_shape=word_main,
              launches_by_path={"width_training": word_launches["forward"]["words"]},
              entry_point="csr_attention_f32 (csrc/csr_attention.cu)",
              also_replaces="graphphysics_tpu/ops/pallas_attention.py:556 (csr_sparse_attention's gathers and "
                            "SDDMM) at the widths without a fast geometry",
              note="the fused f32 forward's word geometry: a word of columns a lane, per-head partials "
                   "reduce-scattered by shuffles, one head's softmax a lane"),
        entry("csr_attention_backward_general", "graphphysics_torch/csrc/attention_words.cuh",
              "graphphysics_tpu/ops/pallas_attention.py:398", word_launches["backward"]["words"],
              [b for _, b in word_cases], {"rtol": K3_GRAD_RTOL, "atol": K3_GRAD_ATOL}, main_shape=word_main,
              launches_by_path={"width_training": word_launches["backward"]["words"]},
              entry_point="csr_attention_bwd_f32 (csrc/csr_attention_bwd.cu)",
              also_replaces="the backward of csr_sparse_attention's gathers and SDDMM "
                            "(graphphysics_tpu/ops/pallas_attention.py:556) at those widths",
              note="the word geometry's backward: dk and dv added as the lane's word"),
    ]
    # the word geometry of the fused bf16 entries (csr_attention_bf16_words.cu),
    # its launches from the bf16 transformer at hidden 48 in 4 heads
    # (bf16_width_training), its time, bound and error at that path's shape:
    # the batch, model view
    word16_launches = bf16_paths["bf16_width_training"]["fused_bf16_launches_by_geometry"]
    word16_cases = [(f, b) for f, b in bf16_kernels if f["geometry"]["forward"] == "words"]
    word16_main = next((i for i, (f, _) in enumerate(word16_cases) if f["shape"] == BF16_WORD_SHAPE), None)
    if word16_main is None or not (word16_launches["forward"]["words"] and word16_launches["backward"]["words"]):
        raise AssertionError(f"the bf16 word geometry: launches {word16_launches} on bf16_width_training, "
                             f"{BF16_WORD_SHAPE} among the timed shapes {[f['shape'] for f, _ in word16_cases]}")
    bf16_tolerance = {"rtol": BF16_KERNEL_RTOL, "atol": BF16_KERNEL_ATOL, "mismatch_share": BF16_MISMATCH_SHARE}
    kernels["kernels"] += [
        entry("csr_attention_bf16_general", "graphphysics_torch/csrc/csr_attention_bf16_words.cu",
              "graphphysics_tpu/ops/pallas_attention.py:255", word16_launches["forward"]["words"],
              [f for f, _ in word16_cases], bf16_tolerance, main_shape=word16_main,
              launches_by_path={"bf16_width_training": word16_launches["forward"]["words"]},
              f32_entry_ms=word16_cases[word16_main][0]["f32_entry_ms"],
              entry_point="csr_attention_bf16_words (csrc/csr_attention_bf16_words.cu)",
              also_replaces="graphphysics_tpu/ops/pallas_attention.py:556 (csr_sparse_attention's gathers and "
                            "SDDMM) on bf16 q, k, v at the widths without the 16-byte geometry",
              note="the fused bf16 forward's word geometry (attention_words.cuh): one word of 8 or 4 bf16 "
                   "columns a lane, per-head partials reduce-scattered by shuffles, one head's softmax a lane"),
        entry("csr_attention_backward_bf16_general", "graphphysics_torch/csrc/csr_attention_bf16_words.cu",
              "graphphysics_tpu/ops/pallas_attention.py:398", word16_launches["backward"]["words"],
              [b for _, b in word16_cases], bf16_tolerance, main_shape=word16_main,
              launches_by_path={"bf16_width_training": word16_launches["backward"]["words"]},
              f32_entry_ms=word16_cases[word16_main][1]["f32_entry_ms"],
              entry_point="csr_attention_bwd_bf16_words (csrc/csr_attention_bf16_words.cu)",
              also_replaces="the backward of csr_sparse_attention's gathers and SDDMM on bf16 q, k, v "
                            "(graphphysics_tpu/ops/pallas_attention.py:556) at those widths",
              note="the word geometry's backward without atomics: part A by sender rows, part B by gather "
                   "rows over gather_csr"),
    ]
    # the 16-bit stream modes' entries: launches from their path alone
    for dt in ("bf16", "f16"):
        shapes = streams[f"csr_segment_sum_{dt}"]
        kernels["kernels"].append(entry(
            f"csr_segment_sum_{dt}", "graphphysics_torch/csrc/csr_segment_sum.cu",
            "graphphysics_tpu/ops/pallas_segment.py:148", launched[f"csr_segment_sum_{dt}"], shapes,
            {"ulps": 1}, f32_entry_ms=shapes[1]["f32_entry_ms"], replaced_ms=shapes[1]["replaced_ms"],
            launches_by_path=by_path[f"csr_segment_sum_{dt}"],
            note=f"K1 on {dt} data (pallas_segment.py:161, :189-193): the sum in f32, rounded once"))
        shapes = streams[f"csr_segment_sum_bwd_{dt}"]
        kernels["kernels"].append(entry(
            f"csr_segment_sum_backward_{dt}", "graphphysics_torch/csrc/csr_segment_sum.cu",
            "graphphysics_tpu/ops/pallas_segment.py:228", launched[f"csr_segment_sum_backward_{dt}"],
            shapes, 0.0, f32_entry_ms=shapes[1]["f32_entry_ms"], replaced_ms=shapes[1]["replaced_ms"],
            launches_by_path=by_path[f"csr_segment_sum_backward_{dt}"]))
    for name, source, replaces in (
            ("csr_softmax_spmm_bf16_stream", "csr_softmax_spmm.cu", "graphphysics_tpu/ops/pallas_attention.py:255"),
            ("csr_softmax_spmm_pair_bf16_stream", "csr_softmax_spmm_pair.cu",
             "graphphysics_tpu/ops/pallas_attention.py:495"),
            ("csr_attention_f32_stream", "csr_attention.cu", "graphphysics_tpu/ops/pallas_attention.py:255"),
            ("csr_attention_bf16_stream", "csr_attention_bf16.cu",
             "graphphysics_tpu/ops/pallas_attention.py:255")):
        shapes = streams[name]
        without = shapes[1].get("f32_entry_ms", shapes[1].get("without_stream_ms"))
        kernels["kernels"].append(entry(
            name, f"graphphysics_torch/csrc/{source}", replaces, launched[name], shapes,
            shapes[1]["tolerance"], without_stream_ms=without, launches_by_path=by_path[name],
            note="stream_dtype=\"bf16\" (pallas_attention.py:275-302): scores and values rounded to "
                 "bf16, then f32"))
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

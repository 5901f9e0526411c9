"""Card tests of the port's CUDA kernels: ``csr_segment_sum``,
``csr_softmax_spmm`` and the fused ``csr_attention`` and their backward
kernels against their plain versions on edge cases, autograd through the
wrappers, a TransformerBlock and the EPD and transformer forwards on the
card against the CPU, two train steps of each model on the card against
the CPU, the aneurysm XDMF path's launches, the ELL layout's train steps
(no kernel), a gradient-accumulation step against the concat step, a
masked filler adding nothing, eval steps exported on the card launching
the kernels, the ops' fake implementations against the kernels,
``flatten_batched_graph`` on CUDA tensors and the data-parallel step on a
1-rank data group against the plain step, and the two 16-bit stream
modes' entries (K1 and K1b on bf16 and f16 data; ``stream_dtype="bf16"``
of K2, K5 and the fused forward) against their plain versions with their
launch counts, and each lane geometry of K1 (f32 and 16-bit), of K2's
f32 entry (by width and heads) and of K2's and K5's stream entries (by
width, heads and alignment). Marked ``cuda``; they skip without a card. This file imports no JAX, so on a machine without it run them
with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _atol(bounds):
    """f32 sums of the same terms in another order: the error grows with
    the longest row's length."""
    longest = int((bounds[1] - bounds[0]).max().item()) if bounds.numel() else 0
    return 1e-5 + 2e-6 * longest


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layout(n, e, seed, hi=None, n_pad=None, e_pad=None):
    from graphphysics_torch.core import pad_graph_sorted_np

    r = np.random.default_rng(seed)
    n_pad = n if n_pad is None else n_pad
    e_pad = e if e_pad is None else e_pad
    recv = r.integers(0, n if hi is None else hi, e).astype(np.int32)
    return pad_graph_sorted_np(
        np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
        r.integers(0, n, e).astype(np.int32), recv, n_pad, e_pad,
    )


@pytest.mark.parametrize(
    "n,e,h,hi,n_pad,e_pad",
    [
        (2048, 11906, 128, None, 2048, 13696),  # serving frame, n_pad == n
        (300, 2000, 48, None, 320, 2048),  # width not a multiple of 32
        (1000, 4000, 128, 5, None, None),  # skewed: long rows, most rows empty
        (64, 0, 16, None, 64, 128),  # only padding edges
        (7, 30, 1, None, None, None),  # width 1
    ],
)
def test_kernel_matches_plain(cuda, n, e, h, hi, n_pad, e_pad):
    from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_reference

    g = _layout(n, e, seed=n + e, hi=hi, n_pad=n_pad, e_pad=e_pad)
    recv = torch.from_numpy(g.receivers).to(cuda)
    bounds = torch.from_numpy(g.row_bounds).to(cuda)
    mask = torch.from_numpy(g.edge_mask).to(cuda)
    mask[::7] = False  # masked edges inside the row ranges too
    data = torch.randn(g.num_edges, h, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    before = csr_segment_sum.launches
    got = csr_segment_sum(data, recv, bounds, mask)
    torch.cuda.synchronize()
    assert csr_segment_sum.launches == before + 1
    want = csr_segment_sum_reference(data, recv, g.num_nodes, mask)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=_atol(bounds))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from graphphysics_torch.ops.csr_segment import csr_segment_sum
    from graphphysics_torch.ops.segment import masked_segment_sum

    g = _layout(32, 100, seed=0)
    recv = torch.from_numpy(g.receivers).to(cuda)
    bounds = torch.from_numpy(g.row_bounds).to(cuda)
    data = torch.randn(100, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        csr_segment_sum(data.double(), recv, bounds)
    with pytest.raises(ValueError, match="contiguous"):
        csr_segment_sum(torch.randn(8, 100, device=cuda).t(), recv, bounds)
    with pytest.raises(ValueError, match="int32"):
        csr_segment_sum(data, recv, bounds.long())
    # a gradient now goes through the backward kernel
    assert csr_segment_sum(data.clone().requires_grad_(True), recv, bounds).requires_grad
    with pytest.raises(ValueError, match="row_bounds"):
        masked_segment_sum(data.detach(), recv, 32)
    # 16-bit data launches the entry of its dtype, with no f32 launch (no
    # upcast), and keeps its dtype
    for dtype, counter in ((torch.float16, csr_segment_sum.f16), (torch.bfloat16, csr_segment_sum.bf16)):
        before, f32_before = counter.launches, csr_segment_sum.launches
        out16 = masked_segment_sum(data.detach().to(dtype), recv, 32, row_bounds=bounds)
        assert out16.dtype == dtype
        assert (counter.launches, csr_segment_sum.launches) == (before + 1, f32_before)


def test_epd_forward_on_card_matches_cpu(cuda):
    from graphphysics_torch.core import pad_graph_sorted_np
    from graphphysics_torch.models import (
        EncodeProcessDecode, Simulator, SimulatorConfig, reset_parameters,
    )
    from graphphysics_torch.ops.csr_segment import csr_segment_sum

    cfg = SimulatorConfig(11, 3, 2, 0, 2, 0, 2, 2)
    r = np.random.default_rng(0)
    n, e = 500, 3000
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    g = pad_graph_sorted_np(
        x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32), 512, 3200,
        edge_attr=r.normal(size=(e, 3)).astype(np.float32),
        y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
    )
    sims = {}
    for dev in ("cpu", "cuda"):
        model = reset_parameters(EncodeProcessDecode(3, 11, 3, 2, 32), torch.Generator().manual_seed(0))
        sims[dev] = Simulator(cfg, model, device=dev)
        sims[dev].accumulate_stats(g.to(dev))
    before = csr_segment_sum.launches
    with torch.inference_mode():
        on_card = sims["cuda"](g.to("cuda"))[2].cpu()
        on_cpu = sims["cpu"](g.to("cpu"))[2]
    assert csr_segment_sum.launches == before + 3
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-4)


def _csr_case(n, e, d, h, seed, hi=None, n_pad=None, e_pad=None, mask_every=5):
    from graphphysics_torch.core import pad_graph_csr_np

    r = np.random.default_rng(seed)
    n_pad = n if n_pad is None else n_pad
    e_pad = e if e_pad is None else e_pad
    g = pad_graph_csr_np(
        np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
        r.integers(0, n if hi is None else hi, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32), n_pad, e_pad,
    )
    gen = torch.Generator().manual_seed(seed)
    scores = 3 * torch.randn(g.num_edges, h, generator=gen)
    values = torch.randn(g.num_edges, d, generator=gen)
    mask = torch.from_numpy(g.edge_mask).clone()
    mask[::mask_every] = False  # masked edges inside the ranges too
    return g, scores, values, mask


@pytest.mark.parametrize(
    "n,e,d,h,hi,n_pad,e_pad",
    [
        (2048, 11906, 128, 4, None, 2048, 13696),  # transformer serving frame, n_pad == n
        (2000, 12000, 64, 4, None, 2048, 12288),  # aneurysm width, padding nodes
        (1000, 4000, 128, 4, 5, 1024, 4096),  # skewed: long rows, most rows empty
        (300, 2000, 96, 4, None, 384, 2048),  # 3 columns a lane: scalar loads
        (300, 2000, 512, 8, None, 384, 2048),  # the widest D
        (128, 0, 32, 4, None, 128, 256),  # only padding edges
    ],
)
def test_softmax_spmm_kernel_matches_plain(cuda, n, e, d, h, hi, n_pad, e_pad):
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm, csr_softmax_spmm_reference

    g, scores, values, mask = _csr_case(n, e, d, h, seed=n + e + d, hi=hi, n_pad=n_pad, e_pad=e_pad)
    seg = torch.from_numpy(g.senders).to(cuda)
    bounds = torch.from_numpy(g.sender_bounds).to(cuda)
    args = (scores.to(cuda), values.to(cuda), seg)
    before = csr_softmax_spmm.launches
    out, ml = csr_softmax_spmm(*args, bounds, mask.to(cuda))
    torch.cuda.synchronize()
    assert csr_softmax_spmm.launches == before + 1
    want_out, want_ml = csr_softmax_spmm_reference(*args, g.num_nodes, mask.to(cuda))
    # online vs two-pass softmax in f32: a few ulps per edge of the longest row
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)


def test_softmax_spmm_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from graphphysics_torch.ops.attention import sparse_graph_attention
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm, csr_softmax_spmm_reference

    g, scores, values, mask = _csr_case(128, 500, 64, 4, seed=0, n_pad=128, e_pad=512)
    seg = torch.from_numpy(g.senders).to(cuda)
    bounds = torch.from_numpy(g.sender_bounds).to(cuda)
    s, v = scores.to(cuda), values.to(cuda)
    with pytest.raises(ValueError, match="float32"):
        csr_softmax_spmm(s.double(), v, seg, bounds)
    # D = 48 (heads of 12), refused before the general geometry: taken now
    # (the padding edges masked, as the ranges leave them out)
    v48, m = v[:, :48].contiguous(), torch.from_numpy(g.edge_mask).to(cuda)
    out, ml = csr_softmax_spmm(s, v48, seg, bounds, m)
    want, want_ml = csr_softmax_spmm_reference(s, v48, seg, g.num_nodes, m)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="at most 512"):
        csr_softmax_spmm(s, torch.zeros(512, 640, device=cuda), seg, bounds)
    with pytest.raises(ValueError, match="multiple of H"):
        csr_softmax_spmm(s[:, :3].contiguous(), v, seg, bounds)
    with pytest.raises(ValueError, match="contiguous"):
        csr_softmax_spmm(s, torch.zeros(64, 512, device=cuda).t(), seg, bounds)
    with pytest.raises(ValueError, match="int32"):
        csr_softmax_spmm(s, v, seg, bounds.long())
    out, ml = csr_softmax_spmm(s.clone().requires_grad_(True), v, seg, bounds)
    assert out.requires_grad and not ml.requires_grad  # the backward kernel takes gradients now
    q = torch.zeros(128, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="sender_bounds"):
        sparse_graph_attention(q, q, q, seg, seg, 128)


def test_transformer_forward_on_card_matches_cpu(cuda):
    from graphphysics_torch.core import pad_graph_csr_np
    from graphphysics_torch.models import (
        EncodeTransformDecode, Simulator, SimulatorConfig, reset_parameters,
    )
    from graphphysics_torch.ops.csr_attention import csr_attention
    from graphphysics_torch.ops.csr_segment import csr_segment_sum

    cfg = SimulatorConfig(11, 0, 3, 0, 2, 0, 3, 3)
    r = np.random.default_rng(0)
    n, e = 500, 3000
    x = r.normal(size=(n, 5)).astype(np.float32)
    x[:, 3] = r.integers(0, 7, n)
    g = pad_graph_csr_np(
        x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
        r.integers(0, n, e).astype(np.int32), 512, 3200,
        y=r.normal(size=(n, 3)).astype(np.float32), node_type_index=3,
    )
    sims = {}
    for dev in ("cpu", "cuda"):
        model = reset_parameters(EncodeTransformDecode(3, 11, 3, 64, 4), torch.Generator().manual_seed(0))
        sims[dev] = Simulator(cfg, model, device=dev)
        sims[dev].accumulate_stats(g.to(dev))
    before = (csr_attention.launches, csr_segment_sum.launches)
    with torch.inference_mode():
        on_card = sims["cuda"](g.to("cuda"))[2].cpu()
        on_cpu = sims["cpu"](g.to("cpu"))[2]
    assert (csr_attention.launches, csr_segment_sum.launches) == (before[0] + 3, before[1])
    torch.testing.assert_close(on_card, on_cpu, rtol=1e-4, atol=1e-4)


def _poison_free_memory(device, mib=64):
    """Leave NaN in the caching allocator's free blocks, so that output rows
    a kernel fails to write show up instead of reading as stale zeros."""
    junk = torch.full((mib * 2**18,), float("nan"), device=device)
    del junk


def _two_sorted_graphs(seed):
    """Two receiver-sorted graphs concatenated: the first graph's padded
    edges sit between real edges; the second has n_pad == n."""
    from graphphysics_torch.core import concat_graphs

    return concat_graphs([_layout(200, 900, seed, n_pad=256, e_pad=1280),
                          _layout(256, 1000, seed + 1, n_pad=256, e_pad=1280)])


@pytest.mark.parametrize(
    "layout,h",
    [("serving", 128), ("skewed", 128), ("two_graphs", 128), ("two_graphs", 6), ("serving", 1)],
)
def test_segment_sum_backward_kernel_matches_plain(cuda, layout, h):
    from graphphysics_torch.ops.csr_segment import (
        csr_segment_sum_backward,
        csr_segment_sum_backward_reference,
    )

    g = {
        "serving": lambda: _layout(2048, 11906, 0, n_pad=2048, e_pad=13696),  # n_pad == n
        "skewed": lambda: _layout(1000, 4000, 1, hi=5, n_pad=1024, e_pad=4096),  # empty rows
        "two_graphs": lambda: _two_sorted_graphs(2),
    }[layout]()
    recv = torch.from_numpy(g.receivers).to(cuda)
    bounds = torch.from_numpy(g.row_bounds).to(cuda)
    mask = torch.from_numpy(g.edge_mask).to(cuda)
    mask[::7] = False
    cot = torch.randn(g.num_nodes, h, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    _poison_free_memory(cuda)
    before = csr_segment_sum_backward.launches
    got = csr_segment_sum_backward(cot, recv, bounds, mask)
    torch.cuda.synchronize()
    assert csr_segment_sum_backward.launches == before + 1
    want = csr_segment_sum_backward_reference(cot, recv, bounds, mask)
    torch.testing.assert_close(got, want, rtol=0, atol=0)  # a gather: exact
    assert torch.all(got[~mask] == 0)


def test_segment_sum_autograd_on_card(cuda):
    from graphphysics_torch.ops.csr_segment import (
        csr_segment_sum,
        csr_segment_sum_backward,
        csr_segment_sum_reference,
    )

    g = _two_sorted_graphs(4)
    recv = torch.from_numpy(g.receivers).to(cuda)
    bounds = torch.from_numpy(g.row_bounds).to(cuda)
    mask = torch.from_numpy(g.edge_mask).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    data = torch.randn(g.num_edges, 64, device=cuda, generator=gen)
    cot = torch.randn(g.num_nodes, 64, device=cuda, generator=gen)
    before = (csr_segment_sum.launches, csr_segment_sum_backward.launches)
    d = data.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(csr_segment_sum(d, recv, bounds, mask), d, cot)
    assert (csr_segment_sum.launches, csr_segment_sum_backward.launches) == (before[0] + 1, before[1] + 1)
    d = data.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(csr_segment_sum_reference(d, recv, g.num_nodes, mask), d, cot)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _two_csr_graphs(seed, d, h):
    """Two sender-sorted graphs concatenated (padding between real edges),
    the second with empty rows, and inputs for them."""
    from graphphysics_torch.core import concat_graphs, pad_graph_csr_np

    r = np.random.default_rng(seed)
    graphs = []
    for n, e, hi in ((200, 900, None), (256, 1000, 100)):
        graphs.append(pad_graph_csr_np(
            np.zeros((n, 1), np.float32), np.zeros((n, 2), np.float32),
            r.integers(0, n if hi is None else hi, e).astype(np.int32),
            r.integers(0, n, e).astype(np.int32), 256, 1280,
        ))
    g = concat_graphs(graphs)
    gen = torch.Generator().manual_seed(seed)
    scores = 3 * torch.randn(g.num_edges, h, generator=gen)
    values = torch.randn(g.num_edges, d, generator=gen)
    mask = torch.from_numpy(g.edge_mask).clone()
    mask[::5] = False
    return g, scores, values, mask


@pytest.mark.parametrize(
    "case,d,h",
    [("serving", 128, 4), ("skewed", 128, 4), ("two_graphs", 128, 4), ("two_graphs", 64, 4),
     ("two_graphs", 96, 4), ("two_graphs", 512, 8), ("two_graphs", 32, 1)],
)
def test_softmax_spmm_backward_kernel_matches_plain(cuda, case, d, h):
    from graphphysics_torch.ops.csr_attention import (
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
        csr_softmax_spmm_backward_reference,
    )

    if case == "two_graphs":
        g, scores, values, mask = _two_csr_graphs(7, d, h)
    elif case == "serving":  # n_pad == n: padded edges on the real last node
        g, scores, values, mask = _csr_case(2048, 11906, d, h, seed=8, n_pad=2048, e_pad=13696)
    else:  # every edge from the first 5 nodes: long rows, most rows empty
        g, scores, values, mask = _csr_case(1000, 4000, d, h, seed=9, hi=5, n_pad=1024, e_pad=4096)
    seg = torch.from_numpy(g.senders).to(cuda)
    bounds = torch.from_numpy(g.sender_bounds).to(cuda)
    s, v, m = scores.to(cuda), values.to(cuda), mask.to(cuda)
    with torch.no_grad():
        out, ml = csr_softmax_spmm(s, v, seg, bounds, m)
    cot = torch.randn(g.num_nodes, d, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    _poison_free_memory(cuda)
    before = csr_softmax_spmm_backward.launches
    got = csr_softmax_spmm_backward(s, v, seg, bounds, ml, out, cot, m)
    torch.cuda.synchronize()
    assert csr_softmax_spmm_backward.launches == before + 1
    want = csr_softmax_spmm_backward_reference(s, v, seg, ml, out, cot, m)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        # expf on the card, exp here; per-head sums in another order
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert torch.all(a[~m] == 0)


def test_softmax_spmm_and_attention_autograd_on_card(cuda):
    from graphphysics_torch.ops.csr_attention import (
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
        csr_sparse_attention,
    )

    g, scores, values, mask = _two_csr_graphs(11, 128, 4)
    args = (torch.from_numpy(g.senders), torch.from_numpy(g.sender_bounds), mask)
    cot = torch.randn(g.num_nodes, 128, generator=torch.Generator().manual_seed(2))
    grads = {}
    for dev in ("cpu", "cuda"):
        s = scores.to(dev).requires_grad_(True)
        v = values.to(dev).requires_grad_(True)
        before = (csr_softmax_spmm.launches, csr_softmax_spmm_backward.launches)
        out, _ = csr_softmax_spmm(s, v, *(a.to(dev) for a in args))
        grads[dev] = torch.autograd.grad(out, (s, v), cot.to(dev))
        step = int(dev == "cuda")
        assert (csr_softmax_spmm.launches, csr_softmax_spmm_backward.launches) == (
            before[0] + step, before[1] + step)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)

    n = g.num_nodes
    qkv = torch.randn(3, n, 4, 32, generator=torch.Generator().manual_seed(3))
    cot = torch.randn(n, 4, 32, generator=torch.Generator().manual_seed(4))
    for dev in ("cpu", "cuda"):
        ts = [t.to(dev).requires_grad_(True) for t in qkv]
        out = csr_sparse_attention(*ts, torch.from_numpy(g.senders).to(dev),
                                   torch.from_numpy(g.receivers).to(dev),
                                   torch.from_numpy(g.sender_bounds).to(dev),
                                   edge_mask=mask.to(dev), scale=0.5)
        grads[dev] = torch.autograd.grad(out, ts, cot.to(dev))
    for a, b in zip(grads["cuda"], grads["cpu"]):
        # dk and dv sum per-edge terms with atomics on the card
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def _fused_case(layout, d, h, seed):
    """A sender-sorted layout with q, k, v (as contiguous [N, H, Dh]
    tensors) and an output gradient for the fused attention kernels."""
    if layout == "two_graphs":
        g, _, _, mask = _two_csr_graphs(seed, d, h)
    elif layout == "serving":  # n_pad == n: padded edges on the real last node
        g, _, _, mask = _csr_case(2048, 11906, d, h, seed=seed, n_pad=2048, e_pad=13696)
    else:  # every edge from the first 5 nodes: long rows, most rows empty
        g, _, _, mask = _csr_case(1000, 4000, d, h, seed=seed, hi=5, n_pad=1024, e_pad=4096)
    gen = torch.Generator().manual_seed(seed)
    qkv = [torch.randn(g.num_nodes, h, d // h, generator=gen) for _ in range(3)]
    cot = torch.randn(g.num_nodes, h, d // h, generator=gen)
    return g, mask, qkv, cot


def _model_view(t):
    """``t`` ([N, H, Dh]) laid out as the model's Attention passes it: the
    transpose of a contiguous (N, Dh, H) tensor."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize(
    "layout,d,h,view",
    [("serving", 128, 4, "model"), ("serving", 128, 4, "contiguous"), ("skewed", 128, 4, "model"),
     ("two_graphs", 64, 4, "model"), ("two_graphs", 64, 4, "contiguous"), ("two_graphs", 96, 4, "model"),
     ("two_graphs", 96, 4, "contiguous"), ("two_graphs", 512, 8, "model"), ("two_graphs", 32, 4, "model"),
     ("two_graphs", 32, 1, "contiguous"),
     # widths without a power-of-two head split: the word geometry (the general one at 32 lanes, 500 x 5)
     ("two_graphs", 48, 4, "model"), ("two_graphs", 48, 4, "contiguous"), ("two_graphs", 96, 3, "model"),
     ("two_graphs", 96, 3, "contiguous"), ("two_graphs", 40, 8, "model"), ("two_graphs", 40, 8, "contiguous"),
     ("skewed", 48, 4, "model"), ("serving", 96, 3, "model"), ("two_graphs", 500, 5, "model")],
)
def test_fused_attention_kernels_match_plain(cuda, layout, d, h, view):
    """Both fused kernels against their plain versions, at every lane count
    whose geometry (fast or general) the kernels take."""
    from graphphysics_torch.ops import csr_attention as ca

    g, mask, qkv, cot = _fused_case(layout, d, h, seed=d + h)
    seg, gather = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.receivers).to(cuda)
    bounds, m = torch.from_numpy(g.sender_bounds).to(cuda), mask.to(cuda)
    q, k, v, g_out = ((_model_view(t) if view == "model" else t).to(cuda) for t in (*qkv, cot))
    interleaved = view == "model" and h > 1
    want_out, want_ml = ca.csr_attention_reference(q, k, v, seg, gather, g.num_nodes, m, 0.5)
    want = ca.csr_attention_backward_reference(q, k, v, seg, gather, want_ml, want_out, g_out, m, 0.5)
    lanes = [n for n in ca.FORWARD_LANES if ca.geometry_kind(n, d, h, interleaved)]
    assert lanes and ca.lanes_per_row(d, h, interleaved) in lanes
    for n in lanes:
        _poison_free_memory(cuda)
        before = (ca.csr_attention.launches, ca.csr_attention_backward.launches)
        out, ml = ca._launch_attention(q, k, v, gather, bounds, m, 0.5, interleaved, lanes=n)
        dq, dkv = ca._launch_attention_backward(q, k, v, gather, bounds, m, ml, out, g_out, 0.5,
                                                interleaved, lanes=n)
        grads = (dq, *dkv.unbind(0))  # the op's outputs: dk and dv share one buffer
        torch.cuda.synchronize()
        assert (ca.csr_attention.launches, ca.csr_attention_backward.launches) == (
            before[0] + 1, before[1] + 1)
        assert ca._is_interleaved(out) is interleaved or h == 1
        # online vs two-pass softmax in f32, as csr_softmax_spmm
        torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5, msg=f"out, {n} lanes")
        torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5, msg=f"ml, {n} lanes")
        for a, b, name in zip(grads, want, "qkv"):
            assert torch.isfinite(a).all()
            # atomics and per-head sums in another order than index_add_
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=f"d{name}, {n} lanes")


# (D, H): widths the fused f32 kernels run in the word geometry in the
# model's view (most in both views): 4-column words with 4, 3, 8, 12 heads,
# an odd count of them (20, 36; 20 in one head), 2-column words
# (D % 4 != 0), single columns (odd D), fewer words than partials
WORD_WIDTHS = [(48, 4), (96, 3), (40, 8), (24, 4), (80, 4), (112, 4), (20, 4), (36, 4), (20, 1), (12, 3),
               (30, 3), (15, 5), (6, 2), (96, 12)]


@pytest.mark.parametrize("view", ["model", "contiguous"])
@pytest.mark.parametrize("d,h", WORD_WIDTHS)
def test_word_geometry_matches_plain(cuda, d, h, view):
    """The fused f32 forward, its bf16 stream and the backward in the word
    geometry (``csrc/attention_words.cuh``) against their plain versions
    on a layout with masked edges and empty rows, through the public
    entries (each launch counted on ``geometries["words"]`` where the rule
    picks it; a width with a fast geometry in the view runs that one) and
    at each of the width's word geometries by its lane count."""
    from graphphysics_torch.ops import csr_attention as ca

    g, mask, qkv, cot = _fused_case("two_graphs", d, h, seed=d * h)
    seg, gather = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.receivers).to(cuda)
    bounds, m = torch.from_numpy(g.sender_bounds).to(cuda), mask.to(cuda)
    q, k, v, g_out = ((_model_view(t) if view == "model" else t).to(cuda) for t in (*qkv, cot))
    interleaved = view == "model" and h > 1
    kinds = [ca.geometry_kind(ca.lanes_per_row(d, h, interleaved, backward=b), d, h, interleaved)
             for b in (False, True)]
    _poison_free_memory(cuda)
    before = (dict(ca.csr_attention.geometries), dict(ca.csr_attention_backward.geometries))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, ml = ca.csr_attention(*leaves, seg, gather, bounds, m, h ** -0.5)
    grads = torch.autograd.grad(out, leaves, g_out)
    torch.cuda.synchronize()
    for counter, old, kind in zip((ca.csr_attention, ca.csr_attention_backward), before, kinds):
        assert counter.geometries[kind] == old[kind] + 1
    assert view == "contiguous" or kinds == ["words", "words"]
    want_out, want_ml = ca.csr_attention_reference(q, k, v, seg, gather, g.num_nodes, m, h ** -0.5)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)
    want = ca.csr_attention_backward_reference(q, k, v, seg, gather, ml, out.detach(), g_out, m, h ** -0.5)
    for a, b in zip(grads, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    # where a fast geometry ran the public entries, the word geometry too,
    # launched by its lane count (where no fast geometry takes that count)
    geo = ca.word_geometry(d, h, interleaved)
    if kinds != ["words", "words"] and ca.geometry_kind(geo.lanes, d, h, interleaved) == "words":
        got, got_ml = ca._launch_attention(q, k, v, gather, bounds, m, h ** -0.5, interleaved, lanes=geo.lanes)
        dq, dkv = ca._launch_attention_backward(q, k, v, gather, bounds, m, got_ml, got, g_out, h ** -0.5,
                                                interleaved, lanes=geo.lanes)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want_out, rtol=1e-5, atol=1e-5, msg=f"out, {geo}")
        torch.testing.assert_close(got_ml, want_ml, rtol=1e-5, atol=1e-5, msg=f"ml, {geo}")
        for a, b, name in zip((dq, *dkv.unbind(0)), want, "qkv"):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=f"d{name}, {geo}")
    # the bf16 stream: q and k on a 1/16 grid, so each score is exact in any
    # order and both sides round the same score to bf16
    qs, ks = _grid(q, interleaved), _grid(k, interleaved)
    with torch.no_grad():
        got, got_ml = ca.csr_attention(qs, ks, v, seg, gather, bounds, m, 0.5, stream_dtype="bf16")
        want_out, want_ml = ca.csr_attention_reference(qs, ks, v, seg, gather, g.num_nodes, m, 0.5,
                                                       stream_dtype="bf16")
        base, _ = ca.csr_attention(qs, ks, v, seg, gather, bounds, m, 0.5)
    torch.testing.assert_close(got, want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_ml, want_ml, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got, base, rtol=1e-5, atol=1e-5)


def test_fused_attention_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from graphphysics_torch.ops.csr_attention import csr_attention

    g, mask, qkv, _ = _fused_case("two_graphs", 64, 4, seed=0)
    seg, gather = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.receivers).to(cuda)
    bounds = torch.from_numpy(g.sender_bounds).to(cuda)
    q, k, v = (t.to(cuda) for t in qkv)
    with pytest.raises(ValueError, match="float32"):
        csr_attention(q.double(), k, v, seg, gather, bounds)
    with pytest.raises(ValueError, match="strides"):
        x = torch.zeros(4, q.shape[0], 16, device=cuda).transpose(0, 1)  # [N, H, Dh], heads outermost
        csr_attention(x, x, x, seg, gather, bounds)
    with pytest.raises(ValueError, match="one layout"):
        csr_attention(_model_view(q), k, v, seg, gather, bounds)
    with pytest.raises(ValueError, match="at most 512"):
        x = torch.zeros(q.shape[0], 4, 160, device=cuda)
        csr_attention(x, x, x, seg, gather, bounds)
    with pytest.raises(ValueError, match="int32"):
        csr_attention(q, k, v, seg, gather.long(), bounds)
    with pytest.raises(ValueError, match="int32"):
        csr_attention(q, k, v, seg, gather, bounds.long())
    with pytest.raises(ValueError, match="sender_bounds"):
        csr_attention(q, k, v, seg, gather, bounds[:, :10].contiguous())
    out, ml = csr_attention(q.clone().requires_grad_(True), k, v, seg, gather, bounds, mask.to(cuda))
    assert out.requires_grad and not ml.requires_grad


def test_transformer_block_on_card_matches_cpu(cuda):
    """One TransformerBlock forward and backward at the model's width on the
    card (the fused kernels, q, k, v in the Attention's own layout) against
    the CPU from equal weights."""
    from graphphysics_torch.models import TransformerBlock, reset_parameters
    from graphphysics_torch.ops.csr_attention import (
        csr_attention,
        csr_attention_backward,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
    )

    g, mask, _, _ = _fused_case("two_graphs", 128, 4, seed=3)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(g.num_nodes, 128, generator=gen)
    cot = torch.randn(g.num_nodes, 128, generator=gen)
    results = {}
    for dev in ("cpu", "cuda"):
        block = reset_parameters(TransformerBlock(128, 4), torch.Generator().manual_seed(5)).to(dev)
        xs = x.to(dev, copy=True).requires_grad_(True)
        counters = (csr_attention, csr_attention_backward, csr_softmax_spmm, csr_softmax_spmm_backward)
        before = [c.launches for c in counters]
        y = block(xs, torch.from_numpy(g.senders).to(dev), torch.from_numpy(g.receivers).to(dev),
                  mask.to(dev), torch.from_numpy(g.sender_bounds).to(dev))
        y.backward(cot.to(dev))
        step = int(dev == "cuda")
        assert [c.launches - b for c, b in zip(counters, before)] == [step, step, 0, 0]
        results[dev] = [y.detach().cpu(), xs.grad.cpu()] + [
            p.grad.cpu() for _, p in sorted(block.named_parameters())]
    for a, b in zip(results["cuda"], results["cpu"]):
        # f32 without TF32; atomics and sums in another order on the card
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _train_param(kind):
    model = {"type": kind, "message_passing_num": 3, "hidden_size": 64, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3 if kind == "epd" else 0, "num_heads": 4}
    return {"model": model, "index": {"feature_index_start": 0, "feature_index_end": 2,
                                      "output_index_start": 0, "output_index_end": 2,
                                      "node_type_index": 2}}


def _train_batch(kind, seed):
    from graphphysics_torch.core import concat_graphs, pad_graph_csr_np, pad_graph_sorted_np

    r = np.random.default_rng(seed)
    graphs = []
    for n, e in ((500, 3000), (512, 3100)):
        x = r.normal(size=(n, 4)).astype(np.float32)
        x[:, 2] = r.integers(0, 7, n)
        pad = pad_graph_sorted_np if kind == "epd" else pad_graph_csr_np
        graphs.append(pad(
            x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
            r.integers(0, n, e).astype(np.int32), 512, 3200,
            edge_attr=r.normal(size=(e, 3)).astype(np.float32) if kind == "epd" else None,
            y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
        ))
    return concat_graphs(graphs)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_two_train_steps_on_card_match_cpu(cuda, kind):
    from graphphysics_torch.ops.csr_attention import (
        csr_attention,
        csr_attention_backward,
        csr_softmax_spmm,
        csr_softmax_spmm_backward,
    )
    from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_backward
    from graphphysics_torch.training import Trainer

    kernels = (csr_segment_sum, csr_segment_sum_backward, csr_attention, csr_attention_backward,
               csr_softmax_spmm, csr_softmax_spmm_backward)
    batches = [_train_batch(kind, seed) for seed in (0, 1)]
    losses, params = {}, {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(_train_param(kind), learning_rate=1e-3, warmup=2, device=dev)
        trainer.init_state(10)
        before = [k.launches for k in kernels]
        losses[dev] = [trainer.train_step(b).item() for b in batches]
        launched = [k.launches - b for k, b in zip(kernels, before)]
        params[dev] = {k: v.detach().cpu() for k, v in trainer.sim.state_dict().items()}
    per_run = 3 * len(batches)  # one launch per block and step
    want = [per_run, per_run, 0, 0, 0, 0] if kind == "epd" else [0, 0, per_run, per_run, 0, 0]
    assert launched == want
    # f32 without TF32 on both; sums in another order, atomics on the card
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for key, value in params["cpu"].items():
        # the key bias's gradient is 0 in exact arithmetic: Adam turns
        # round-off into +-lr steps on both devices
        atol = 2 * 2 * 1e-3 if key.endswith("k_proj.bias") else 1e-5
        torch.testing.assert_close(params["cuda"][key], value, rtol=1e-5, atol=atol, msg=key)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_checkpoint_saved_on_card_loads_on_cpu(cuda, kind, tmp_path):
    """A checkpoint of a trainer on the card holds CPU tensors only and
    restores its weights, normalizers, optimizer state and step on the CPU
    exactly; one more step from it on each device agrees."""
    from graphphysics_torch.training import Trainer, load_checkpoint

    kw = dict(learning_rate=1e-3, warmup=2, checkpoint_dir=str(tmp_path), metrics_path=None,
              rollout_dir=None)
    card = Trainer(_train_param(kind), device=cuda, **kw)
    card.init_state(10)
    batches = [_train_batch(kind, seed) for seed in (0, 1, 2)]
    for b in batches[:2]:
        card.train_step(b)
    card.save(0)
    path = tmp_path / "state.pt"
    raw = torch.load(path, weights_only=True)

    def devices(obj):
        if isinstance(obj, torch.Tensor):
            return {obj.device.type}
        if isinstance(obj, dict):
            return set().union(*map(devices, obj.values())) if obj else set()
        if isinstance(obj, (list, tuple)):
            return set().union(*map(devices, obj)) if obj else set()
        return set()

    assert devices(raw) == {"cpu"}
    cpu = Trainer(_train_param(kind), device="cpu", **kw)
    cpu.init_state(10)
    load_checkpoint(str(path), cpu)
    assert cpu.step == card.step == 2
    for key, value in card.sim.state_dict().items():
        assert torch.equal(cpu.sim.state_dict()[key], value.cpu()), key
    card_opt, cpu_opt = card.optimizer.state_dict()["state"], cpu.optimizer.state_dict()["state"]
    for i, state in card_opt.items():
        for name, value in state.items():
            assert torch.equal(cpu_opt[i][name], value.cpu()), (i, name)
    assert cpu.optimizer.param_groups[0]["lr"] == card.optimizer.param_groups[0]["lr"]
    losses = [t.train_step(batches[2]).item() for t in (card, cpu)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


@pytest.mark.parametrize("config", ["coarse-aneurysm", "c-a-gmm"])
def test_aneurysm_xdmf_path_launches_the_fused_kernels(cuda, config, tmp_path):
    """The XDMF path on the card: an inline-XML aneurysm folder (the card's
    format, ``chip_fidelity.write_aneurysm_inline``) through ``get_dataset``
    with previous data and the aneurysm features, two train steps on each
    device from equal weights (one fused forward and one fused backward per
    block and step on the card, none on the CPU), then a rollout with the
    previous-data slice fed back: one fused forward per block and frame, and
    the plain head's frames against the CPU's."""
    import json
    import pathlib
    import sys

    from graphphysics_torch.core import concat_graphs, stack_graphs
    from graphphysics_torch.external import build_features
    from graphphysics_torch.ops.csr_attention import csr_attention, csr_attention_backward
    from graphphysics_torch.training import Trainer, get_dataset, get_preprocessing, rollout

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_fidelity

    folder, meta_path = chip_fidelity.write_aneurysm_inline(str(tmp_path / "data"), 2, 5, 5, seed=0)
    with open(root / "training_config" / f"{config}.json") as fp:
        param = json.load(fp)
    param["dataset"].update(xdmf_folder=folder, meta_path=meta_path)
    param["model"].update(message_passing_num=3, hidden_size=32)
    previous = {"use_previous_data": True, "previous_data_start": 5, "previous_data_end": 8}
    ds = get_dataset(param, get_preprocessing(param, use_edge_feature=False,
                                              extra_node_features=build_features),
                     use_edge_feature=False, use_previous_data=True)
    batches = [concat_graphs([ds[0], ds[4]]), concat_graphs([ds[1], ds[5]])]
    losses, sims = {}, {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(param, learning_rate=1e-3, warmup=2, device=dev, **previous)
        trainer.init_state(10)
        before = (csr_attention.launches, csr_attention_backward.launches)
        losses[dev] = [trainer.train_step(b).item() for b in batches]
        launched = (csr_attention.launches - before[0], csr_attention_backward.launches - before[1])
        assert launched == ((3 * len(batches),) * 2 if dev == "cuda" else (0, 0))
        sims[dev] = trainer.sim.eval()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    frames = stack_graphs([ds[i] for i in ds.trajectory_indices(0)])
    K = param["model"].get("num_mixture_components", 0)
    gens = {dev: torch.Generator(device=dev).manual_seed(0) if K else None for dev in sims}
    before = csr_attention.launches
    preds = {dev: rollout(sims[dev], frames, device=dev, generator=gens[dev], **previous)[0].cpu()
             for dev in ("cuda", "cpu")}
    assert csr_attention.launches - before == 3 * frames.x.shape[0]
    assert torch.isfinite(preds["cuda"]).all()
    if not K:
        real = torch.as_tensor(frames.node_mask[0])
        torch.testing.assert_close(preds["cuda"][:, real], preds["cpu"][:, real], rtol=1e-4,
                                   atol=1e-4)


# bf16 entries against their plain versions: both compute in f32 and round
# each output to bf16 once, so they differ where f32 sums in another order
# round to neighbouring bf16 values: one bf16 ulp (2^-7 of the value at
# most), two where a cancelling difference (the backward's ds) or dv's
# per-edge roundings carry f32 round-off past one; plus f32 round-off near
# zero, and for dv one edge term rounded the other way (2^-8 of max |g|)
BF16_RTOL, BF16_ATOL, BF16_DV_TERM = 2.0 ** -6, 1e-4, 2.0 ** -8


@pytest.mark.parametrize(
    "layout,d,h,view",
    [("serving", 128, 4, "model"), ("skewed", 128, 4, "model"), ("two_graphs", 64, 4, "model"),
     ("two_graphs", 64, 4, "contiguous"), ("two_graphs", 48, 4, "model"),
     ("two_graphs", 48, 4, "contiguous"), ("two_graphs", 96, 3, "model"), ("two_graphs", 40, 8, "model"),
     ("two_graphs", 512, 8, "model"), ("two_graphs", 32, 1, "contiguous"), ("serving", 128, 16, "model")],
)
def test_fused_attention_bf16_kernels_match_plain(cuda, layout, d, h, view):
    """``csr_attention_bf16`` and ``csr_attention_bwd_bf16`` against the
    plain versions on the same bf16 inputs, at every geometry the bf16
    kernels take for the shape (16-byte lanes of 8 or 16 columns, the word
    geometry, the general one); the launches count on the bf16 entries
    only, by the geometry that ran, every output is bf16 in q's layout, and
    the backward gives the same bits on a second call (no atomics)."""
    from graphphysics_torch.ops import csr_attention as ca

    g, mask, qkv, cot = _fused_case(layout, d, h, seed=d + h + 1)
    seg, gather = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.receivers).to(cuda)
    bounds, m = torch.from_numpy(g.sender_bounds).to(cuda), mask.to(cuda)
    q, k, v, g_out = ((_model_view(t) if view == "model" else t).to(cuda, torch.bfloat16)
                      for t in (*qkv, cot))
    interleaved = view == "model" and h > 1
    tc = ca.gather_csr(seg, gather, bounds, m)
    want_out, want_ml = ca.csr_attention_reference(q, k, v, seg, gather, g.num_nodes, m, 0.5)
    geometries = ca.bf16_geometries(d, h, interleaved)
    kinds = [kind for _, kind in geometries]
    assert kinds[-1] == "general" and ("fast" in kinds) is (d in (32, 64, 128, 512))  # 16-byte lanes
    assert ("words" in kinds) is (d <= 256)  # at most 32 lanes of 16-byte words
    for n, kind in geometries:
        _poison_free_memory(cuda)
        before = {name: c.launches for name, c in ca.LAUNCHES.items()}
        by_kind = (ca.csr_attention.bf16.geometries[kind], ca.csr_attention_backward.bf16.geometries[kind])
        out, ml = ca._launch_attention(q, k, v, gather, bounds, m, 0.5, interleaved, lanes=n, kind=kind)
        want = ca.csr_attention_backward_reference(q, k, v, seg, gather, ml, out, g_out, m, 0.5)
        grads, again = ((dq, *dkv.unbind(0)) for dq, dkv in (
            ca._launch_attention_backward(q, k, v, gather, bounds, m, ml, out, g_out, 0.5,
                                          interleaved, lanes=n, kind=kind, gather=tc)
            for _ in range(2)))
        torch.cuda.synchronize()
        after = {name: c.launches - before[name] for name, c in ca.LAUNCHES.items()}
        assert after == {"csr_attention_f32": 0, "csr_attention_bf16": 1, "csr_attention_f32_stream": 0,
                         "csr_attention_bf16_stream": 0, "csr_attention_bwd_f32": 0,
                         "csr_attention_bwd_bf16": 2}
        assert (ca.csr_attention.bf16.geometries[kind], ca.csr_attention_backward.bf16.geometries[kind]) == (
            by_kind[0] + 1, by_kind[1] + 2)
        assert out.dtype == torch.bfloat16 and ml.dtype == torch.float32
        assert ca._is_interleaved(out) is interleaved or h == 1
        where = f"{n} lanes, {kind} geometry"
        torch.testing.assert_close(out.float(), want_out.float(), rtol=BF16_RTOL, atol=BF16_ATOL,
                                   msg=f"out, {where}")
        torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5, msg=f"ml, {where}")
        dv_atol = max(BF16_ATOL, BF16_DV_TERM * g_out.float().abs().max().item())
        for a, b, c, name in zip(grads, want, again, "qkv"):
            assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
            assert ca._is_interleaved(a) is interleaved or h == 1
            torch.testing.assert_close(a.float(), b.float(), rtol=BF16_RTOL,
                                       atol=dv_atol if name == "v" else BF16_ATOL,
                                       msg=f"d{name}, {where}")
            assert torch.equal(a, c), f"d{name} differs between two calls, {where}"


# (D, H): the widths the bf16 entries run in the word geometry: 16-byte
# words at 48 x 4, 96 x 3, 40 x 8 (and 128 x 4, which runs the 16-byte
# geometry through the public entries); 8-byte words where D % 8 == 4, an
# odd count of them (20, 36; 20 in one head)
BF16_WORD_WIDTHS = [(48, 4), (96, 3), (40, 8), (128, 4), (20, 4), (36, 4), (20, 1)]


def _eight_byte_view(t, view):
    """``t`` ([N, H, Dh]) in ``view`` ("model": the transpose of an (N, Dh,
    H) tensor; else contiguous) in a buffer whose base is 8 bytes past a
    16-byte boundary: every row base 8-byte, not 16-byte, aligned."""
    n, h, dh = t.shape
    src = t.transpose(1, 2) if view == "model" else t
    flat = torch.empty(n * h * dh + 4, dtype=t.dtype, device=t.device)[4:]
    out = flat.view(src.shape).copy_(src)
    return out.transpose(1, 2) if view == "model" else out


@pytest.mark.parametrize("view", ["model", "contiguous", "model_8_byte"])
@pytest.mark.parametrize("d,h", BF16_WORD_WIDTHS)
def test_bf16_word_geometry_matches_plain(cuda, d, h, view):
    """The bf16 forward, its stream twin and the backward in the word
    geometry (``csrc/csr_attention_bf16_words.cu``) against their plain
    versions on a layout with masked edges and empty rows: through the
    public entries (each launch counted by the geometry that ran: the words
    wherever no 16-byte geometry takes the shape; an 8-byte-aligned view
    takes 4-column words) and, where a 16-byte geometry ran, the word
    geometry by its lanes; the backward the same bits on a second call."""
    from graphphysics_torch.ops import csr_attention as ca

    g, mask, qkv, cot = _fused_case("two_graphs", d, h, seed=d * h + 3)
    seg, gather = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.receivers).to(cuda)
    bounds, m = torch.from_numpy(g.sender_bounds).to(cuda), mask.to(cuda)
    layout = "contiguous" if view == "contiguous" else "model"
    q, k, v, g_out = ((_model_view(t) if layout == "model" else t).to(cuda, torch.bfloat16)
                      for t in (*qkv, cot))
    if view == "model_8_byte":
        q, k, v, g_out = (_eight_byte_view(t, layout) for t in (q, k, v, g_out))
    interleaved = layout == "model" and h > 1
    aligned = ca._aligned(q, k, v, g_out)
    assert aligned is (view != "model_8_byte")
    words = ca.bf16_word_geometry(d, h, interleaved, aligned)
    assert words is not None and d % words.cols == 0 and words.cols == (8 if aligned and d % 8 == 0 else 4)
    kind = ca.bf16_geometry(d, h, interleaved, aligned)[1]
    assert kind == ("fast" if d == 128 and aligned else "words")
    tc = ca.gather_csr(seg, gather, bounds, m)
    scale = h ** -0.5
    want_out, want_ml = ca.csr_attention_reference(q, k, v, seg, gather, g.num_nodes, m, scale)
    runs = [("public", None)] + ([("words", words.lanes)] if kind != "words" else [])
    for label, lanes in runs:
        _poison_free_memory(cuda)
        before = (dict(ca.csr_attention.bf16.geometries), dict(ca.csr_attention_backward.bf16.geometries))
        if lanes is None:  # q, k, v as they are: a clone would lose the 8-byte view
            with torch.no_grad():
                out, ml = ca.csr_attention(q, k, v, seg, gather, bounds, m, scale, tc)
        else:
            out, ml = ca._launch_attention(q, k, v, gather, bounds, m, scale, interleaved, lanes=lanes,
                                           kind="words")
        grads, again = ((dq, *dkv.unbind(0)) for dq, dkv in (
            ca._launch_attention_backward(q, k, v, gather, bounds, m, ml, out, g_out, scale, interleaved,
                                          lanes=lanes, kind=None if lanes is None else "words", gather=tc)
            for _ in range(2)))
        torch.cuda.synchronize()
        ran = "words" if lanes is not None else kind
        assert ca.csr_attention.bf16.geometries[ran] == before[0][ran] + 1, label
        assert ca.csr_attention_backward.bf16.geometries[ran] == before[1][ran] + 2, label
        torch.testing.assert_close(out.float(), want_out.float(), rtol=BF16_RTOL, atol=BF16_ATOL, msg=label)
        torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5, msg=label)
        want = ca.csr_attention_backward_reference(q, k, v, seg, gather, ml, out, g_out, m, scale)
        dv_atol = max(BF16_ATOL, BF16_DV_TERM * g_out.float().abs().max().item())
        for a, b, c, name in zip(grads, want, again, "qkv"):
            assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
            assert ca._is_interleaved(a) is interleaved or h == 1
            torch.testing.assert_close(a.float(), b.float(), rtol=BF16_RTOL,
                                       atol=dv_atol if name == "v" else BF16_ATOL, msg=f"d{name}, {label}")
            assert torch.equal(a, c), f"d{name} differs between two calls, {label}"
    # the bf16 stream: q and k on a 1/16 grid, so each score is exact in any
    # order and both sides round the same score to bf16
    qs, ks = (_grid(t.float(), interleaved).to(torch.bfloat16) for t in (q, k))
    if view == "model_8_byte":
        qs, ks = (_eight_byte_view(t, layout) for t in (qs, ks))
    before = ca.csr_attention.bf16_stream.geometries[kind]
    with torch.no_grad():
        got, got_ml = ca.csr_attention(qs, ks, v, seg, gather, bounds, m, 0.5, stream_dtype="bf16")
        want_out, want_ml = ca.csr_attention_reference(qs, ks, v, seg, gather, g.num_nodes, m, 0.5,
                                                       stream_dtype="bf16")
        base, _ = ca.csr_attention(qs, ks, v, seg, gather, bounds, m, 0.5)
    torch.cuda.synchronize()
    assert ca.csr_attention.bf16_stream.geometries[kind] == before + 1
    torch.testing.assert_close(got.float(), want_out.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
    torch.testing.assert_close(got_ml, want_ml, rtol=1e-5, atol=1e-5)
    assert not torch.equal(got, base)


def test_fused_attention_bf16_refusals(cuda):
    """bf16 q, k, v launch the bf16 entries or raise: mixed dtypes, a width
    that is not a multiple of 4, a row base that is not 8-byte aligned, a
    backward without the graph's transposed CSR."""
    from graphphysics_torch.ops.csr_attention import csr_attention

    g, mask, qkv, _ = _fused_case("two_graphs", 64, 4, seed=0)
    seg, gather = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.receivers).to(cuda)
    bounds = torch.from_numpy(g.sender_bounds).to(cuda)
    q, k, v = (t.to(cuda, torch.bfloat16) for t in qkv)
    n = q.shape[0]
    with pytest.raises(ValueError, match="share one dtype"):
        csr_attention(q, k.float(), v, seg, gather, bounds)
    with pytest.raises(ValueError, match="multiple of 4"):
        x = torch.zeros(n, 2, 3, device=cuda, dtype=torch.bfloat16)
        csr_attention(x, x, x, seg, gather, bounds)
    with pytest.raises(ValueError, match="8-byte aligned"):
        x = torch.zeros(n * 64 + 2, device=cuda, dtype=torch.bfloat16)[2:].view(n, 4, 16)
        csr_attention(x, x, x, seg, gather, bounds)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        csr_attention(q.half(), k.half(), v.half(), seg, gather, bounds)
    with pytest.raises(ValueError, match="gather_csr"):  # no atomic path to fall back to
        q.requires_grad_(True)
        out, _ = csr_attention(q, k, v, seg, gather, bounds)
        out.float().sum().backward()


def test_bf16_train_steps_on_card_launch_the_bf16_entries(cuda):
    """Two train steps of the bf16 transformer on the card against the CPU
    in bf16: the fused attention runs its bf16 entries (3 blocks, one
    launch each a step), the f32 ones never, and the transposed CSR is
    built once a step on the card, never on the CPU."""
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.training import Trainer

    batches = [_train_batch("transformer", seed) for seed in (0, 1)]
    param = _train_param("transformer")
    param["model"]["precision"] = "bf16"
    losses = {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(param, learning_rate=1e-3, warmup=2, device=dev)
        trainer.init_state(10)
        before = {name: c.launches for name, c in ca.LAUNCHES.items()}
        builds = ca.gather_csr.launches
        losses[dev] = [trainer.train_step(b).item() for b in batches]
        launched = {name: c.launches - before[name] for name, c in ca.LAUNCHES.items()}
        assert ca.gather_csr.launches - builds == (len(batches) if dev == "cuda" else 0)
        assert all(p.dtype == torch.float32 for p in trainer.sim.parameters())
    per_run = 3 * len(batches)
    assert launched == {"csr_attention_f32": 0, "csr_attention_bf16": per_run, "csr_attention_f32_stream": 0,
                        "csr_attention_bf16_stream": 0, "csr_attention_bwd_f32": 0,
                        "csr_attention_bwd_bf16": per_run}
    # bf16 on both devices: roundings that fall the other way where f32
    # sums differ in order
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-2)


def _kernel_launches():
    from graphphysics_torch.ops.csr_attention import csr_attention, csr_attention_backward
    from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_backward

    return [k.launches for k in (csr_segment_sum, csr_segment_sum_backward, csr_attention,
                                 csr_attention_backward)]


def _ell_batch(kind, seed):
    from graphphysics_torch.core import concat_graphs, pad_graph_ell_np
    from graphphysics_torch.topology import to_undirected

    r = np.random.default_rng(seed)
    graphs = []
    for n in (500, 512):
        s, t = to_undirected(r.integers(0, n, 3 * n).astype(np.int32),
                             r.integers(0, n, 3 * n).astype(np.int32))
        x = r.normal(size=(n, 4)).astype(np.float32)
        x[:, 2] = r.integers(0, 7, n)
        graphs.append(pad_graph_ell_np(
            x, r.normal(size=(n, 2)).astype(np.float32), s, t, 512, 20,
            edge_attr=r.normal(size=(len(s), 3)).astype(np.float32) if kind == "epd" else None,
            y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2))
    return concat_graphs(graphs)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_ell_train_steps_on_card_match_cpu_without_kernels(cuda, kind):
    """The ELL layout on the card: the dense ELL ops, no kernel launched,
    two steps within the f32 limits of the sorted and CSR layouts'."""
    from graphphysics_torch.training import Trainer

    batches = [_ell_batch(kind, seed) for seed in (0, 1)]
    losses, params = {}, {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(_train_param(kind), learning_rate=1e-3, warmup=2, device=dev)
        trainer.init_state(10)
        before = _kernel_launches()
        losses[dev] = [trainer.train_step(b).item() for b in batches]
        assert _kernel_launches() == before
        params[dev] = {k: v.detach().cpu() for k, v in trainer.sim.state_dict().items()}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
    for key, value in params["cpu"].items():
        atol = 2 * 2 * 1e-3 if key.endswith("k_proj.bias") else 1e-5
        torch.testing.assert_close(params["cuda"][key], value, rtol=1e-5, atol=atol, msg=key)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_accumulation_step_on_card_matches_the_concat_step(cuda, kind):
    """One gradient-accumulation step over the batch's 2 graphs as
    microbatches against the concat step, on the card: the loss and the
    parameters within the step limits, the counters advanced once, and one
    forward and one backward launch a block and microbatch."""
    from graphphysics_torch.core import stack_graphs
    from graphphysics_torch.training import Trainer

    parts = _train_graphs(kind, 0)  # 500 and 400 real nodes: a mean of means would differ
    results = {}
    for accumulate in (False, True):
        trainer = Trainer(_train_param(kind), learning_rate=1e-3, warmup=2, device="cuda",
                          gradient_accumulation=accumulate)
        trainer.init_state(10)
        before = _kernel_launches()
        g = stack_graphs(parts) if accumulate else concat_graphs_of(parts)
        loss = trainer.train_step(g).item()
        launched = [a - b for a, b in zip(_kernel_launches(), before)]
        counts = [m._num_accumulations.item() for m in trainer.sim.modules()
                  if type(m).__name__ == "Normalizer"]
        results[accumulate] = (loss, {k: v.detach().cpu() for k, v in trainer.sim.state_dict().items()},
                               launched, counts)
    (loss_c, sd_c, launched_c, counts_c), (loss_m, sd_m, launched_m, counts_m) = results[False], results[True]
    np.testing.assert_allclose(loss_m, loss_c, rtol=1e-5)
    assert counts_m == counts_c and all(c == 1.0 for c in counts_m)
    per = 3  # blocks
    assert launched_c == ([per, per, 0, 0] if kind == "epd" else [0, 0, per, per])
    assert launched_m == [2 * v for v in launched_c]
    for key, value in sd_c.items():
        atol = 2 * 2 * 1e-3 if key.endswith("k_proj.bias") else 1e-5
        torch.testing.assert_close(sd_m[key], value, rtol=2e-4, atol=atol, msg=key)


def _train_graphs(kind, seed):
    from graphphysics_torch.core import pad_graph_csr_np, pad_graph_sorted_np

    r = np.random.default_rng(seed)
    graphs = []
    for n, e in ((500, 3000), (400, 2500)):
        x = r.normal(size=(n, 4)).astype(np.float32)
        x[:, 2] = r.integers(0, 7, n)
        pad = pad_graph_sorted_np if kind == "epd" else pad_graph_csr_np
        graphs.append(pad(
            x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
            r.integers(0, n, e).astype(np.int32), 512, 3200,
            edge_attr=r.normal(size=(e, 3)).astype(np.float32) if kind == "epd" else None,
            y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
        ))
    return graphs


def concat_graphs_of(graphs):
    from graphphysics_torch.core import concat_graphs

    return concat_graphs(graphs)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_masked_filler_adds_nothing_on_card(cuda, kind):
    """A batch with a masked copy of its last graph against the real graphs
    alone, on the card: the kernels skip the filler's masked edges, so the
    loss, the gradients and the normalizer statistics are equal."""
    from graphphysics_torch.core import masked_filler
    from graphphysics_torch.training import Trainer

    real = _train_graphs(kind, 1)
    results = []
    for graphs in (real, real + [masked_filler(real[-1])]):
        trainer = Trainer(_train_param(kind), learning_rate=1e-3, warmup=2, device="cuda")
        trainer.init_state(1)
        batch = concat_graphs_of(graphs).to("cuda")
        out, target, _ = trainer.sim(batch, is_training=True)
        loss = trainer.loss(target, out, batch)
        loss.backward()
        results.append((loss.item(), {n: p.grad.cpu() for n, p in trainer.sim.named_parameters()},
                        {k: v.cpu() for k, v in trainer.sim.state_dict().items() if "normalizer" in k}))
    (la, ga, sa), (lb, gb, sb) = results
    np.testing.assert_allclose(lb, la, rtol=1e-6)
    for name, g in ga.items():
        torch.testing.assert_close(gb[name], g, rtol=1e-5, atol=1e-7, msg=name)
    for key, v in sa.items():
        torch.testing.assert_close(sb[key], v, rtol=1e-6, atol=1e-6, msg=key)


def _export_sim(kind, precision=None):
    from graphphysics_torch.core import pad_graph_csr_np, pad_graph_sorted_np
    from graphphysics_torch.training import get_simulator

    model = {"type": kind, "message_passing_num": 2, "hidden_size": 32, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3 if kind == "epd" else 0}
    if kind == "transformer":
        model["num_heads"] = 4
    if precision:
        model["precision"] = precision
    param = {"model": model, "index": {"feature_index_start": 0, "feature_index_end": 2,
                                       "output_index_start": 0, "output_index_end": 2,
                                       "node_type_index": 2}}
    r = np.random.default_rng(3)
    n, e = 500, 2500
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    pad = pad_graph_sorted_np if kind == "epd" else pad_graph_csr_np
    g = pad(x, r.normal(size=(n, 2)).astype(np.float32), r.integers(0, n, e).astype(np.int32),
            r.integers(0, n, e).astype(np.int32), 512, 2560,
            edge_attr=r.normal(size=(e, 3)).astype(np.float32) if kind == "epd" else None,
            y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2).to("cuda")
    sim = get_simulator(param, device="cuda")
    sim.accumulate_stats(g)
    return sim.eval(), g


@pytest.mark.parametrize("kind,precision,counter", [
    ("epd", None, "csr_segment_sum"), ("transformer", None, "csr_attention"),
    ("transformer", "bf16", "csr_attention_bf16")])
def test_exported_eval_step_on_card_launches_the_kernels(cuda, kind, precision, counter):
    """An eval step exported on the card, loaded back, launches the
    hand-written kernel of each block (by the counters) and gives the live
    step's output."""
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops import csr_segment as cs
    from graphphysics_torch.utils.export import export_eval_step, load_eval_step

    counters = {"csr_segment_sum": cs.csr_segment_sum, "csr_attention": ca.csr_attention,
                "csr_attention_bf16": ca.csr_attention.bf16}
    sim, g = _export_sim(kind, precision)
    step = load_eval_step(export_eval_step(sim, g))
    before = {k: c.launches for k, c in counters.items()}
    got = step(g)
    torch.cuda.synchronize()
    after = {k: c.launches - before[k] for k, c in counters.items()}
    assert after == {k: (2 if k == counter else 0) for k in counters}
    with torch.inference_mode():
        want = sim(g)[2]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_fake_implementations_give_the_kernels_shapes_and_strides(cuda):
    """Each op's fake implementation against its CUDA implementation (the
    kernel) on card tensors: shapes, dtypes and strides, so a program traced
    on the card lays its tensors out as the kernels do."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops import csr_segment as cs

    g = _layout(600, 3000, 5, n_pad=640, e_pad=3072)
    rec, rb, em = (torch.from_numpy(a).to(cuda) for a in (g.receivers, g.row_bounds, g.edge_mask))
    gen = torch.Generator(device=cuda).manual_seed(0)
    data = torch.randn(g.num_edges, 64, device=cuda, generator=gen)
    scores, values = torch.randn(g.num_edges, 4, device=cuda, generator=gen), data
    out, ml = ca.csr_softmax_spmm(scores, values, rec, rb, em)
    cases = [(cs._segment_sum_op, (data, rec, rb, em)),
             (cs._segment_sum_backward_op, (torch.randn(640, 64, device=cuda), rec, rb, em)),
             (ca._softmax_spmm_op, (scores, values, rec, rb, em)),
             (ca._softmax_spmm_backward_op, (scores, values, rec, rb, ml, out, torch.ones_like(out), em))]
    empty = (scores[:8].contiguous(), values[:8].contiguous(), rec[:8].contiguous(),
             torch.zeros_like(rb), torch.zeros(8, dtype=torch.bool, device=cuda))
    out, ml = ca.csr_softmax_spmm_pair(scores, values, rec, rb, *empty[:4], em, empty[4])
    cases += [(ca._pair_op, (scores, values, rec, rb, em, *empty)),
              (ca._pair_backward_op, (scores, values, rec, rb, *empty[:4], ml, out,
                                      torch.ones_like(out), em, empty[4]))]
    from graphphysics_torch.core import pad_graph_csr_np

    r = np.random.default_rng(7)
    tg = pad_graph_csr_np(np.zeros((600, 1), np.float32), np.zeros((600, 2), np.float32),
                          r.integers(0, 600, 3000).astype(np.int32),
                          r.integers(0, 600, 3000).astype(np.int32), 640, 3072)
    seg, gather, bounds, mask = (torch.from_numpy(a).to(cuda) for a in
                                 (tg.senders, tg.receivers, tg.sender_bounds, tg.edge_mask))
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(640, 32, 4, device=cuda, generator=gen).to(dtype).transpose(1, 2)
                   for _ in range(3))  # the model's (N, Dh, H) views
        tc = ca._gather_args(ca.gather_csr(seg, gather, bounds, mask))
        out, ml = ca.csr_attention(q, k, v, seg, gather, bounds, mask, 0.5)
        cases += [(ca._attention_op, (q, k, v, seg, gather, bounds, mask, 0.5, *tc)),
                  (ca._attention_backward_op, (q, k, v, seg, gather, bounds, ml, out,
                                               torch.ones_like(out), mask, 0.5, *tc))]
    # the 16-bit entries of K1 and K1b, and the bf16 stream's entries
    for dtype in (torch.bfloat16, torch.float16):
        cases += [(cs._segment_sum_op, (data.to(dtype), rec, rb, em)),
                  (cs._segment_sum_backward_op, (torch.randn(640, 64, device=cuda).to(dtype), rec, rb, em))]
    cases += [(ca._softmax_spmm_op, (scores, values, rec, rb, em, "bf16")),
              (ca._pair_op, (scores, values, rec, rb, em, *empty, "bf16"))]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(640, 32, 4, device=cuda, generator=gen).to(dtype).transpose(1, 2)
                   for _ in range(3))
        cases.append((ca._attention_op, (q, k, v, seg, gather, bounds, mask, 0.5, None, None, None, "bf16")))
    for op in (ca._softmax_spmm_op, ca._pair_op, ca._attention_op):
        arg = op._schema.arguments[-1]
        assert (arg.name, arg.default_value) == ("stream_dtype", "f32"), op
    for op, args in cases:
        real = op(*args)
        with FakeTensorMode() as mode:
            fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
        real = real if isinstance(real, tuple) else (real,)
        fake = fake if isinstance(fake, tuple) else (fake,)
        for r, f in zip(real, fake, strict=True):
            assert (tuple(f.shape), f.dtype, f.stride(), f.device) == (
                tuple(r.shape), r.dtype, r.stride(), r.device), op


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_flatten_batched_graph_on_card_equals_concat(cuda, kind):
    """``flatten_batched_graph`` of a stacked batch of CUDA tensors equals
    ``concat_graphs`` of its host graphs bit for bit (row and sender bounds
    moved by a graph's edge count)."""
    import dataclasses

    from graphphysics_torch.core import concat_graphs, flatten_batched_graph, stack_graphs

    graphs = _train_graphs(kind, 1)
    got = flatten_batched_graph(stack_graphs(graphs).to("cuda"))
    want = concat_graphs(graphs)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None or not hasattr(b, "shape"):
            assert a == b, f.name
            continue
        assert a.is_cuda, f.name
        np.testing.assert_array_equal(a.cpu().numpy(), b, err_msg=f.name)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_dp_step_on_one_rank_equals_the_plain_step(cuda, kind, tmp_path):
    """``make_dp_train_step`` over a 1-rank data group on the card (one gloo
    rank, the batch stacked) equals the Trainer's plain step on the concat
    batch: loss, counters and parameters within the step limits, the same
    kernel launches."""
    import torch.distributed as dist

    from graphphysics_torch.core import concat_graphs, stack_graphs
    from graphphysics_torch.parallel import make_dp_train_step
    from graphphysics_torch.parallel.mesh import DATA_AXIS, _GROUPS, register_group
    from graphphysics_torch.training import Trainer

    graphs = _train_graphs(kind, 2)
    results = {}
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        register_group(None, DATA_AXIS)
        for dp in (False, True):
            trainer = Trainer(_train_param(kind), learning_rate=1e-3, warmup=2, device="cuda")
            trainer.init_state(10)
            before = _kernel_launches()
            if dp:
                step = make_dp_train_step(trainer.sim, trainer.optimizer, trainer.masks)
                loss = step(stack_graphs(graphs)).item()
            else:
                loss = trainer.train_step(concat_graphs(graphs)).item()
            launched = [a - b for a, b in zip(_kernel_launches(), before)]
            counts = [m._num_accumulations.item() for m in trainer.sim.modules()
                      if type(m).__name__ == "Normalizer"]
            results[dp] = (loss, {k: v.detach().cpu() for k, v in trainer.sim.state_dict().items()},
                           launched, counts)
    finally:
        dist.destroy_process_group()
        _GROUPS.clear()
    (loss_p, sd_p, launched_p, counts_p), (loss_d, sd_d, launched_d, counts_d) = results[False], results[True]
    np.testing.assert_allclose(loss_d, loss_p, rtol=1e-5)
    assert counts_d == counts_p and all(c == 1.0 for c in counts_d)
    assert launched_d == launched_p == ([3, 3, 0, 0] if kind == "epd" else [0, 0, 3, 3])
    for key, value in sd_p.items():
        atol = 2 * 2 * 1e-3 if key.endswith("k_proj.bias") else 1e-5
        torch.testing.assert_close(sd_d[key], value, rtol=2e-4, atol=atol, msg=key)


def _ulps(got, want):
    """The largest gap between two tensors of one 16-bit dtype, in units in
    the last place of ``want``'s values."""
    dtype = want.dtype
    mantissa = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    mag = want.float().abs().clamp_min(torch.finfo(dtype).tiny)
    _, exp = torch.frexp(mag)
    return ((got.float() - want.float()).abs() / torch.exp2((exp - 1 - mantissa).float())).max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize(
    "n,e,h,hi,n_pad,e_pad",
    [
        (2048, 11906, 128, None, 2048, 13696),  # serving frame: pairs of columns, 16-byte gathers
        (300, 2000, 48, None, 320, 2048),  # width 48
        (1000, 4000, 128, 5, None, None),  # skewed: long rows, most rows empty
        (64, 0, 16, None, 64, 128),  # only padding edges
        (7, 30, 1, None, None, None),  # width 1: one column a lane, one a gather thread
    ],
)
def test_segment_sum_16bit_kernels_match_plain(cuda, dtype, n, e, h, hi, n_pad, e_pad):
    """K1's and K1b's 16-bit entries against their plain versions: the
    forward within one unit in the last place of the dtype (both sum in f32
    and round once), the gradient bit for bit; each launches its own entry
    once and no f32 entry."""
    from graphphysics_torch.ops.csr_segment import (
        csr_segment_sum,
        csr_segment_sum_backward,
        csr_segment_sum_backward_reference,
        csr_segment_sum_reference,
    )

    g = _layout(n, e, seed=n + e + 1, hi=hi, n_pad=n_pad, e_pad=e_pad)
    recv, bounds, mask = (torch.from_numpy(a).to(cuda) for a in (g.receivers, g.row_bounds, g.edge_mask))
    mask[::7] = False
    gen = torch.Generator(device=cuda).manual_seed(2)
    data = torch.randn(g.num_edges, h, device=cuda, generator=gen).to(dtype)
    g_out = torch.randn(g.num_nodes, h, device=cuda, generator=gen).to(dtype)
    key = "bf16" if dtype == torch.bfloat16 else "f16"
    counters = (getattr(csr_segment_sum, key), getattr(csr_segment_sum_backward, key), csr_segment_sum,
                csr_segment_sum_backward)
    before = [c.launches for c in counters]
    d = data.clone().requires_grad_(True)
    out = csr_segment_sum(d, recv, bounds, mask)
    (grad,) = torch.autograd.grad(out, d, g_out)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
    assert out.dtype == dtype and grad.dtype == dtype
    assert _ulps(out, csr_segment_sum_reference(data, recv, g.num_nodes, mask)) <= 1
    assert torch.equal(grad, csr_segment_sum_backward_reference(g_out, recv, bounds, mask))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
def test_segment_sum_16bit_hub_row_reads_4096(cuda, dtype):
    """4,096 unit edges into one node read exactly 4,096 in the 16-bit
    entry (a sum kept in bf16 stops at 256, in f16 at 2,048), with rows
    whose base is 4-byte aligned (column pairs) and only 2-byte aligned
    (single columns)."""
    from graphphysics_torch.ops.csr_segment import compute_row_bounds, csr_segment_sum

    n, hub = 64, 4096
    recv_np = np.concatenate([np.zeros(hub, np.int32), np.arange(1, n, dtype=np.int32)])
    recv = torch.from_numpy(recv_np).to(cuda)
    bounds = torch.from_numpy(compute_row_bounds(recv_np, n)).to(cuda)
    e, h = len(recv_np), 8
    aligned = torch.ones(e, h, dtype=dtype, device=cuda)
    shifted = torch.ones(e * h + 1, dtype=dtype, device=cuda)[1:].view(e, h)  # 2-byte aligned
    for data in (aligned, shifted):
        out = csr_segment_sum(data, recv, bounds)
        assert out.dtype == dtype
        assert bool((out[0].float() == hub).all()) and bool((out[1:].float() == 1).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("h", [128, 64, 48, 8, 512, 127])
def test_segment_sum_16bit_geometries_give_the_same_bits(cuda, dtype, h):
    """The 16-bit K1 in each geometry its rule gives a width, on data 16-,
    4- and 2-byte aligned (16-byte words, 4-byte pairs, single columns; an
    odd width single columns at every alignment): within one ulp of the
    plain version, the same bits on a second run and in every geometry,
    which all add a row's edges in edge order in f32. Rows of about 20
    edges (several windows of the words geometry), masked edges inside the
    ranges, most rows empty."""
    from chip_stream import view_at
    from graphphysics_torch.ops.csr_segment import (
        alignment,
        csr_segment_sum,
        csr_segment_sum_reference,
        segment_sum_geometry,
    )

    g = _layout(1000, 6000, seed=h, hi=300, n_pad=1024, e_pad=6144)
    recv, bounds, mask = (torch.from_numpy(a).to(cuda) for a in (g.receivers, g.row_bounds, g.edge_mask))
    mask[::7] = False
    gen = torch.Generator(device=cuda).manual_seed(h)
    data = torch.randn(g.num_edges, h, device=cuda, generator=gen).to(dtype)
    want = csr_segment_sum_reference(data, recv, g.num_nodes, mask)
    outs, kinds = [], []
    for aligned in (16, 4, 2):
        d = view_at(data, aligned)
        kinds.append(segment_sum_geometry(h, dtype, alignment(d)).kind)
        first, second = csr_segment_sum(d, recv, bounds, mask), csr_segment_sum(d, recv, bounds, mask)
        assert torch.equal(first, second), kinds[-1]
        assert _ulps(first, want) <= 1, kinds[-1]
        outs.append(first)
    assert kinds == (["words16", "pairs", "columns"] if h % 8 == 0 else ["columns"] * 3)
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.parametrize("h", [128, 64, 48, 130])
def test_segment_sum_f32_geometries_give_the_same_bits(cuda, h):
    """The f32 K1 in each geometry its rule gives a width, on data 16- and
    4-byte aligned (16-byte words of 4 columns, single columns; a width
    that is not a multiple of 4 single columns at both): within
    ``KERNEL_ATOL`` of the plain version, the same bits on a second run and
    in both geometries, which add a row's edges in edge order in f32; each
    launch counted on the geometry that ran. Rows of about 20 edges
    (several windows of the words geometry), masked edges inside the
    ranges, most rows empty."""
    from chip_stream import view_at
    from graphphysics_torch.ops.csr_segment import (
        alignment,
        csr_segment_sum,
        csr_segment_sum_reference,
        segment_sum_geometry,
    )

    g = _layout(1000, 6000, seed=h, hi=300, n_pad=1024, e_pad=6144)
    recv, bounds, mask = (torch.from_numpy(a).to(cuda) for a in (g.receivers, g.row_bounds, g.edge_mask))
    mask[::7] = False
    gen = torch.Generator(device=cuda).manual_seed(h)
    data = torch.randn(g.num_edges, h, device=cuda, generator=gen)
    want = csr_segment_sum_reference(data, recv, g.num_nodes, mask)
    outs, kinds = [], []
    for aligned in (16, 4):
        d = view_at(data, aligned)
        kinds.append(segment_sum_geometry(h, d.dtype, alignment(d)).kind)
        before = dict(csr_segment_sum.geometries)
        first, second = csr_segment_sum(d, recv, bounds, mask), csr_segment_sum(d, recv, bounds, mask)
        torch.cuda.synchronize()
        assert csr_segment_sum.geometries[kinds[-1]] - before[kinds[-1]] == 2
        assert torch.equal(first, second), kinds[-1]
        assert (first - want).abs().max().item() <= 1e-4, kinds[-1]
        outs.append(first)
    assert kinds == (["words16", "columns"] if h % 4 == 0 else ["columns"] * 2)
    assert torch.equal(outs[0], outs[1])


def test_segment_sum_f32_hub_row_reads_4096(cuda):
    """4,096 unit edges into one node read exactly 4,096 in the f32 entry's
    16-byte words and in single columns (a 4-byte aligned view), the same
    bits in both."""
    from chip_stream import view_at
    from graphphysics_torch.ops.csr_segment import alignment, compute_row_bounds, csr_segment_sum

    n, hub, h = 64, 4096, 128
    recv_np = np.concatenate([np.zeros(hub, np.int32), np.arange(1, n, dtype=np.int32)])
    recv = torch.from_numpy(recv_np).to(cuda)
    bounds = torch.from_numpy(compute_row_bounds(recv_np, n)).to(cuda)
    outs = []
    for aligned in (16, 4):
        data = view_at(torch.ones(len(recv_np), h, device=cuda), aligned)
        assert alignment(data) == aligned
        out = csr_segment_sum(data, recv, bounds)
        assert bool((out[0] == hub).all()) and bool((out[1:] == 1).all())
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


def _split_rows(bounds: np.ndarray):
    """Each row's range of a sender-sorted layout cut in two: the first
    half of its edges in set a, the rest in set b. Returns each set's edge
    ids (into the layout) and per-row ranges ``[2, N]`` into its own array."""
    sets = ([], [])
    ranges = np.zeros((2, 2, bounds.shape[1]), np.int32)
    for r, (lo, hi) in enumerate(bounds.T):
        mid = lo + (hi - lo + 1) // 2
        for k, (a, b) in enumerate(((lo, mid), (mid, hi))):
            ranges[k, 0, r] = sum(len(x) for x in sets[k])
            sets[k].append(np.arange(a, b))
            ranges[k, 1, r] = ranges[k, 0, r] + (b - a)
    return [np.concatenate(x).astype(np.int64) for x in sets], ranges


@pytest.mark.parametrize(
    "width,heads,aligned,kind",
    [
        (128, 4, 16, "words16"),  # 16 lanes a row, two rows a warp
        (64, 4, 16, "words16"),  # 8 lanes, four rows
        (256, 8, 16, "words16"),  # 32 lanes, one row
        (48, 4, 16, "words8"),  # heads of 12: 8-byte words, 12 lanes of 16
        (128, 4, 8, "words8"),  # 8-byte aligned values
        (40, 8, 16, "general"),  # heads of 5
        (128, 4, 4, "general"),  # 4-byte aligned values
    ],
)
def test_pair_stream_geometries_match_plain(cuda, width, heads, aligned, kind):
    """K5's bf16 stream entry in each geometry its rule gives (by width,
    heads and the values' alignment), on rows whose edges are split over
    both sets: against its plain version (the f32 function of the bf16
    values) and the same bits on a second run."""
    from chip_stream import view_at
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import alignment

    g, scores, values, mask = _csr_case(1000, 6000, width, heads, seed=width + heads, hi=300, n_pad=1024,
                                        e_pad=6144)
    (ia, ib), ranges = _split_rows(g.sender_bounds)
    seg = torch.from_numpy(g.senders).long()
    n = g.num_nodes
    parts = []
    for idx, rng in zip((ia, ib), ranges):
        i = torch.from_numpy(idx)
        parts.append((scores[i].to(cuda, torch.bfloat16), view_at(values[i].to(cuda, torch.bfloat16), aligned),
                      seg[i].to(cuda, torch.int32), torch.from_numpy(rng).to(cuda), mask[i].to(cuda)))
    (sa, va, ga, ba, ma), (sb, vb, gb, bb, mb) = parts
    assert ca.stream_geometry(width, heads, alignment(va, vb)).kind == kind
    out, ml = ca._launch_pair(sa, va, ba, ma, sb, vb, bb, mb)
    again, again_ml = ca._launch_pair(sa, va, ba, ma, sb, vb, bb, mb)
    assert torch.equal(out, again) and torch.equal(ml, again_ml)
    want, want_ml = ca.csr_softmax_spmm_pair_reference(sa.float(), va.float(), ga, sb.float(), vb.float(), gb, n,
                                                       ma, mb)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "width,heads,aligned,kind",
    [
        (128, 4, 16, "words16"),  # 16 lanes a row, two rows a warp
        (64, 4, 16, "words16"),  # 8 lanes, four rows
        (32, 4, 16, "words16"),  # 4 lanes, eight rows
        (32, 8, 16, "words8"),  # heads of 4: 8-byte words
        (128, 4, 8, "words8"),  # 8-byte aligned values
        (64, 4, 4, "general"),  # 4-byte aligned values: 4-byte loads of 2 columns
        (512, 4, 16, "general"),  # past 32 words
        (48, 4, 16, "words8"),  # heads of 12: 12 lanes of 16 (refused before the general geometry)
        (96, 3, 16, "words16"),  # heads of 32: 12 lanes of 16
        (40, 8, 16, "general"),  # heads of 5: strided columns
        (128, 4, 4, "general"),  # strided: 8-byte loads of 4 columns on a 4-byte view
        (512, 4, 8, "general"),  # strided: 16-byte loads on an 8-byte view
    ],
)
def test_softmax_spmm_stream_geometries_match_plain(cuda, width, heads, aligned, kind):
    """K2's bf16 stream entry in each geometry its rule gives (by width,
    heads and the values' alignment), on rows of about 20 edges with
    masked edges inside them and empty rows: against its plain version
    (the f32 function of the bf16 values), the same bits on a second run,
    and farther than that tolerance from the f32 mode."""
    from chip_stream import view_at
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import alignment

    g, scores, values, mask = _csr_case(1000, 6000, width, heads, seed=width + heads, hi=300, n_pad=1024,
                                        e_pad=6144)
    seg, bounds, m = (torch.from_numpy(a).to(cuda) for a in (g.senders, g.sender_bounds, mask.numpy()))
    s = torch.where(m[:, None], scores.to(cuda), torch.full((), ca.NEG, device=cuda))
    v = values.to(cuda)
    s16, v16 = s.to(torch.bfloat16), view_at(v.to(torch.bfloat16), aligned)
    assert ca.stream_geometry(width, heads, alignment(v16)).kind == kind
    out, ml = ca._launch(s16, v16, bounds, m)
    again, again_ml = ca._launch(s16, v16, bounds, m)
    assert torch.equal(out, again) and torch.equal(ml, again_ml)
    want, want_ml = ca.csr_softmax_spmm_reference(s16.float(), v16.float(), seg, g.num_nodes, m)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)
    f32, _ = ca.csr_softmax_spmm(s, v, seg, bounds, m)
    assert not torch.allclose(out, f32, rtol=1e-5, atol=1e-5)


def test_softmax_spmm_stream_takes_a_view_its_vector_loads_do_not(cuda):
    """Values whose alignment neither the word geometries nor the V-column
    kernel's vector loads take (D = 128, 4 heads, a 4-byte aligned bf16
    view), which K2's bf16 stream entry refused before, take the general
    geometry's strided columns: against the plain version, the same bits
    twice."""
    from chip_stream import view_at
    from graphphysics_torch.ops import csr_attention as ca

    g, scores, values, mask = _csr_case(128, 500, 128, 4, seed=0, n_pad=128, e_pad=512)
    seg, bounds, m = (torch.from_numpy(a).to(cuda) for a in (g.senders, g.sender_bounds, mask.numpy()))
    s16, v16 = scores.to(cuda, torch.bfloat16), view_at(values.to(cuda, torch.bfloat16), 4)
    assert ca.stream_geometry(128, 4, 4).kind == "general"
    assert ca.softmax_spmm_columns(128, 4, 4, itemsize=2) == "strided"
    out, ml = ca._launch(s16, v16, bounds, m)
    again, again_ml = ca._launch(s16, v16, bounds, m)
    assert torch.equal(out, again) and torch.equal(ml, again_ml)
    want, want_ml = ca.csr_softmax_spmm_reference(s16.float(), v16.float(), seg, g.num_nodes, m)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)


F32_GEOMETRY_CASES = [
    (128, 4, "words16"),  # 32 lanes a row: the mesh part's, the frame's and the batch's width
    (128, 8, "words16"),  # heads of 16
    (64, 4, "words16"),  # 16 lanes, two rows a warp: the aneurysm width
    (32, 8, "words16"),  # heads of 4: 8 lanes, four rows a warp
    (32, 16, "general"),  # heads of 2: one column a lane
    (256, 4, "general"),  # 8 columns a lane
    (512, 8, "general"),  # 16 columns a lane
    (40, 8, "general"),  # heads of 5: strided columns (refused before the general geometry)
    (48, 4, "words16"),  # heads of 12: 12 lanes of 16
    (96, 3, "words16"),  # heads of 32: 24 lanes of 32
]


def _f32_rows_case(width, heads, cuda):
    """``_csr_case`` rows of about 20 edges (a fifth masked) with empty rows,
    scores masked as ``csr_sparse_attention`` masks them, and one row whose
    edges are all masked; returns the layout's tensors on the card and
    the rows that must read as empty."""
    from graphphysics_torch.ops import csr_attention as ca

    g, scores, values, mask = _csr_case(1000, 6000, width, heads, seed=width + heads, hi=300, n_pad=1024,
                                        e_pad=6144)
    lo, hi = (int(x) for x in g.sender_bounds[:, 7])
    assert hi - lo > 8  # more than one window
    mask[lo:hi] = False
    seg, bounds, m = (torch.from_numpy(a).to(cuda) for a in (g.senders, g.sender_bounds, mask.numpy()))
    s = torch.where(m[:, None], scores.to(cuda), torch.full((), ca.NEG, device=cuda))
    empty = [r for r in range(g.num_nodes) if r == 7 or g.sender_bounds[0, r] == g.sender_bounds[1, r]]
    assert len(empty) > 100
    return seg, bounds, m, s, values.to(cuda), g.num_nodes, torch.tensor(empty, device=cuda)


@pytest.mark.parametrize("width,heads,kind", F32_GEOMETRY_CASES)
def test_softmax_spmm_f32_geometries_match_plain(cuda, width, heads, kind):
    """K2's f32 entry in each geometry its rule gives (by width and heads):
    against its plain version, the same bits on a second run, and empty
    rows and a row of only masked edges exactly out = 0, m = -1e30, l = 0."""
    from graphphysics_torch.ops import csr_attention as ca

    seg, bounds, m, s, v, n, empty = _f32_rows_case(width, heads, cuda)
    assert ca.softmax_spmm_geometry(width, heads).kind == kind
    before = ca.csr_softmax_spmm.launches
    out, ml = ca.csr_softmax_spmm(s, v, seg, bounds, m)
    again, again_ml = ca.csr_softmax_spmm(s, v, seg, bounds, m)
    torch.cuda.synchronize()
    assert ca.csr_softmax_spmm.launches == before + 2
    assert torch.equal(out, again) and torch.equal(ml, again_ml)
    want, want_ml = ca.csr_softmax_spmm_reference(s, v, seg, n, m)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)
    assert bool((out[empty] == 0).all())
    assert bool((ml[:heads, empty] == ca.NEG).all()) and bool((ml[heads:, empty] == 0).all())


@pytest.mark.parametrize("width", [128, 64])
def test_softmax_spmm_f32_hub_row_matches_plain(cuda, width):
    """A row of 4,096 edges (a tenth masked) beside 63 rows of one edge,
    in 16-byte words: against the plain version, the same bits twice."""
    from chip_stream import HUB_EDGES
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import compute_row_bounds

    n, heads = 64, 4
    seg_np = np.concatenate([np.zeros(HUB_EDGES, np.int32), np.arange(1, n, dtype=np.int32)])
    gen = torch.Generator(device=cuda).manual_seed(width)
    e = len(seg_np)
    m = torch.rand(e, generator=gen, device=cuda) >= 0.1
    s = torch.where(m[:, None], 3 * torch.randn((e, heads), generator=gen, device=cuda),
                    torch.full((), ca.NEG, device=cuda))
    v = torch.randn((e, width), generator=gen, device=cuda)
    seg = torch.from_numpy(seg_np).to(cuda)
    bounds = torch.from_numpy(compute_row_bounds(seg_np, n)).to(cuda)
    assert ca.softmax_spmm_geometry(width, heads).kind == "words16"
    out, ml = ca.csr_softmax_spmm(s, v, seg, bounds, m)
    again, _ = ca.csr_softmax_spmm(s, v, seg, bounds, m)
    assert torch.equal(out, again)
    want, want_ml = ca.csr_softmax_spmm_reference(s, v, seg, n, m)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)
    assert float(ml[heads:, 0].min()) > 1.0


def test_softmax_spmm_f32_takes_a_view_not_16_byte_aligned(cuda):
    """f32 values that are not 16-byte aligned, which the wrapper refused
    before the general geometry: taken now, by the public call and by the
    entry itself, in the strided general geometry (D = 128: no 16-byte
    words; D = 256: 8 columns a lane would load 16 bytes), against the
    plain version, K3 on them against its plain version."""
    from chip_stream import view_at
    from graphphysics_torch.ops import csr_attention as ca

    for width, heads in ((128, 4), (256, 4)):
        g, scores, values, mask = _csr_case(128, 500, width, heads, seed=0, n_pad=128, e_pad=512)
        seg, bounds = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.sender_bounds).to(cuda)
        s, v, m = scores.to(cuda), view_at(values.to(cuda), 8), mask.to(cuda)
        assert ca.softmax_spmm_geometry(width, heads, 8).kind == "general"
        assert ca.softmax_spmm_columns(width, heads, 8) == "strided"
        out, ml = ca.csr_softmax_spmm(s, v, seg, bounds, m)
        direct, direct_ml = ca._launch(s, v, bounds, m)
        assert torch.equal(out, direct) and torch.equal(ml, direct_ml)
        want, want_ml = ca.csr_softmax_spmm_reference(s, v, seg, g.num_nodes, m)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)
        cot = torch.randn((g.num_nodes, width), device=cuda, generator=torch.Generator(device=cuda).manual_seed(2))
        got = ca.csr_softmax_spmm_backward(s, v, seg, bounds, ml, out, cot, m)
        for a, b in zip(got, ca.csr_softmax_spmm_backward_reference(s, v, seg, ml, out, cot, m)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            assert torch.all(a[~m] == 0)


@pytest.mark.parametrize("width,heads", [(128, 4), (64, 4), (32, 16)])
def test_softmax_spmm_f32_autograd_matches_plain(cuda, width, heads):
    """Autograd through ``csr_softmax_spmm`` on the card (K2's f32 entry in
    its geometry, then K3 on that pass's ``ml`` and ``out``) against
    autograd through the plain version on the same card."""
    from graphphysics_torch.ops import csr_attention as ca

    seg, bounds, m, s, v, n, _ = _f32_rows_case(width, heads, cuda)
    cot = torch.randn((n, width), generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    grads = []
    for kernel in (True, False):
        si, vi = s.clone().requires_grad_(True), v.clone().requires_grad_(True)
        before = (ca.csr_softmax_spmm.launches, ca.csr_softmax_spmm_backward.launches)
        if kernel:
            out, _ = ca.csr_softmax_spmm(si, vi, seg, bounds, m)
        else:
            out, _ = ca.csr_softmax_spmm_reference(si, vi, seg, n, m)
        grads.append(torch.autograd.grad(out, (si, vi), cot))
        step = int(kernel)
        assert (ca.csr_softmax_spmm.launches, ca.csr_softmax_spmm_backward.launches) == (
            before[0] + step, before[1] + step)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# (D, H) that JAX's K2 takes and the port's K2 and K3 refused before the
# general geometry: heads of 4, 5, 12, 32 and 8
GENERAL_WIDTHS = [(16, 4), (40, 8), (48, 4), (96, 3), (24, 3)]


@pytest.mark.parametrize("aligned", [16, 4])
@pytest.mark.parametrize("stream_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width,heads", GENERAL_WIDTHS)
def test_softmax_spmm_general_widths_match_plain(cuda, width, heads, stream_dtype, aligned):
    """K2 (f32 and bf16 stream entries) and K3 at the widths that only JAX
    took, on values ``aligned``-byte aligned (a 4-byte view: no vector
    loads): the forward against its plain version, the same bits twice,
    empty rows and a row of only masked edges exactly out = 0, m = -1e30,
    l = 0; K3 against its plain version with exact zeros on masked and
    padded edges, the same bits twice; autograd through the public call
    against autograd through the plain version, one launch of each."""
    from chip_stream import view_at
    from graphphysics_torch.ops import csr_attention as ca
    from graphphysics_torch.ops.csr_segment import alignment

    seg, bounds, m, s, v, n, empty = _f32_rows_case(width, heads, cuda)
    v = view_at(v, aligned)
    bf16 = stream_dtype == "bf16"
    assert alignment(v) == aligned
    kind = ca.stream_geometry(width, heads, aligned) if bf16 else ca.softmax_spmm_geometry(width, heads, aligned)
    if kind.kind == "general":
        assert ca.softmax_spmm_columns(width, heads, aligned, 2 if bf16 else 4) == "strided"
    # the entry on the (rounded) inputs, twice
    sk, vk = (s.to(torch.bfloat16), view_at(v.to(torch.bfloat16), aligned)) if bf16 else (s, v)
    out, ml = ca._launch(sk, vk, bounds, m)
    again, again_ml = ca._launch(sk, vk, bounds, m)
    assert torch.equal(out, again) and torch.equal(ml, again_ml)
    want, want_ml = ca.csr_softmax_spmm_reference(sk.float(), vk.float(), seg, n, m)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)
    assert bool((out[empty] == 0).all())
    assert bool((ml[:heads, empty] == ca.NEG).all()) and bool((ml[heads:, empty] == 0).all())
    # K3 on the unrounded inputs with this pass's ml and out (poisoned memory:
    # an edge row it does not write shows)
    cot = torch.randn((n, width), generator=torch.Generator(device=cuda).manual_seed(width), device=cuda)
    _poison_free_memory(cuda)
    ds, dv = ca.csr_softmax_spmm_backward(s, v, seg, bounds, ml, out, cot, m)
    ds2, dv2 = ca.csr_softmax_spmm_backward(s, v, seg, bounds, ml, out, cot, m)
    assert torch.equal(ds, ds2) and torch.equal(dv, dv2)
    for a, b in zip((ds, dv), ca.csr_softmax_spmm_backward_reference(s, v, seg, ml, out, cot, m)):
        assert torch.isfinite(a).all() and torch.all(a[~m] == 0)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # autograd through the public call: one forward and one backward launch
    counter = ca.csr_softmax_spmm.bf16_stream if bf16 else ca.csr_softmax_spmm
    before = (counter.launches, ca.csr_softmax_spmm_backward.launches)
    grads = []
    for kernel in (True, False):
        si, vi = s.clone().requires_grad_(True), v.clone().requires_grad_(True)
        if kernel:
            o, _ = ca.csr_softmax_spmm(si, vi, seg, bounds, m, stream_dtype=stream_dtype)
        else:
            o, _ = ca.csr_softmax_spmm_reference(ca.stream_round(si) if bf16 else si,
                                                 ca.stream_round(vi) if bf16 else vi, seg, n, m)
        grads.append(torch.autograd.grad(o, (si, vi), cot))
    torch.cuda.synchronize()
    assert (counter.launches, ca.csr_softmax_spmm_backward.launches) == (before[0] + 1, before[1] + 1)
    if not bf16:  # the stream's gradient is the f32 one at the stream's ml, not plain's rounded one
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _grid(t, interleaved):
    """``t`` on a 1/16 grid in [-2, 2] in its layout: with a power-of-two
    scale every f32 score is then exact in any summation order, so the
    kernel and the plain version round the same score to bf16."""
    from graphphysics_torch.ops.csr_attention import _in_layout

    return _in_layout((t * 16).round().clamp(-32, 32) / 16, interleaved)


@pytest.mark.parametrize("width", [128, 48])
def test_stream_entries_match_plain_and_differ_from_f32(cuda, width):
    """``stream_dtype="bf16"`` of K2, K5 and the fused forward on f32 and
    bf16 q, k, v: each against its plain version (the f32 function of the
    bf16-rounded inputs), each
    farther than that tolerance from the mode without the stream, each
    stream entry launched once and the gradients through the existing
    backward entries, against their plain versions on the unrounded inputs
    with the stream pass's ml and out."""
    from graphphysics_torch.ops import csr_attention as ca

    tol = dict(rtol=1e-5, atol=1e-5)
    gtol = dict(rtol=1e-4, atol=1e-4)
    h = 4
    g, scores, values, mask = _csr_case(2000, 12000, width, h, seed=3, n_pad=2048, e_pad=12288)
    seg, bounds = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.sender_bounds).to(cuda)
    s, v, m = scores.to(cuda), values.to(cuda), mask.to(cuda)
    n = g.num_nodes
    cot = torch.randn(n, width, device=cuda)

    def counts(*counters):
        return [c.launches for c in counters]

    leaves = [s.clone().requires_grad_(True), v.clone().requires_grad_(True)]
    before = counts(ca.csr_softmax_spmm.bf16_stream, ca.csr_softmax_spmm, ca.csr_softmax_spmm_backward)
    out, ml = ca.csr_softmax_spmm(*leaves, seg, bounds, m, stream_dtype="bf16")
    grads = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(ca.csr_softmax_spmm.bf16_stream, ca.csr_softmax_spmm,
                                         ca.csr_softmax_spmm_backward), before)] == [1, 0, 1]
    want, want_ml = ca.csr_softmax_spmm_reference(ca.stream_round(s), ca.stream_round(v), seg, n, m)
    torch.testing.assert_close(out, want, **tol)
    torch.testing.assert_close(ml, want_ml, **tol)
    for a, b in zip(grads, ca.csr_softmax_spmm_backward_reference(s, v, seg, ml, out, cot, m)):
        torch.testing.assert_close(a, b, **gtol)
    assert not torch.allclose(out, ca.csr_softmax_spmm(s, v, seg, bounds, m)[0], **tol)

    # K5: the edges split in two sets at a row boundary, each with its ranges
    half = int(bounds[0, n // 2].item())
    sets = []
    for lo, hi in ((0, half), (half, s.shape[0])):
        b = bounds.clone()
        b[0] = b[0].clamp(lo, hi) - lo
        b[1] = b[1].clamp(lo, hi) - lo
        sets.append((s[lo:hi].contiguous(), v[lo:hi].contiguous(), seg[lo:hi].contiguous(), b.contiguous(),
                     m[lo:hi].contiguous()))
    (sa, va, ga, ba, ma), (sb, vb, gb, bb, mb) = sets
    leaves = [t.clone().requires_grad_(True) for t in (sa, va, sb, vb)]
    pair_counters = (ca.csr_softmax_spmm_pair.bf16_stream, ca.csr_softmax_spmm_pair,
                     ca.csr_softmax_spmm_pair_backward)
    before = counts(*pair_counters)
    out, ml = ca.csr_softmax_spmm_pair(leaves[0], leaves[1], ga, ba, leaves[2], leaves[3], gb, bb, ma, mb,
                                       stream_dtype="bf16")
    grads = torch.autograd.grad(out, leaves, cot)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(*pair_counters), before)] == [1, 0, 1]
    r = [ca.stream_round(t) for t in (sa, va, sb, vb)]
    want, want_ml = ca.csr_softmax_spmm_pair_reference(r[0], r[1], ga, r[2], r[3], gb, n, ma, mb)
    torch.testing.assert_close(out, want, **tol)
    torch.testing.assert_close(ml, want_ml, **tol)
    want_grads = ca.csr_softmax_spmm_pair_backward_reference(sa, va, ga, sb, vb, gb, ml, out, cot, ma, mb)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, **gtol)
    f32, _ = ca.csr_softmax_spmm_pair(sa, va, ga, ba, sb, vb, gb, bb, ma, mb)
    assert not torch.allclose(out, f32, **tol)

    # the fused forward, f32 and bf16 q, k, v in the model's (N, Dh, H) view
    gen = torch.Generator(device=cuda).manual_seed(4)
    qkv = [torch.randn(n, width // h, h, device=cuda, generator=gen).transpose(1, 2) for _ in range(3)]
    qkv[0], qkv[1] = _grid(qkv[0], True), _grid(qkv[1], True)
    g_out = torch.randn(n, width // h, h, device=cuda, generator=gen).transpose(1, 2)
    gather = torch.from_numpy(g.receivers).to(cuda)
    bf16_tol = dict(rtol=BF16_RTOL, atol=BF16_ATOL)
    dv_tol = dict(rtol=BF16_RTOL, atol=max(BF16_ATOL, BF16_DV_TERM * g_out.abs().max().item()))
    for dtype, stream_counter, fwd_counter, bwd_counter, ftol, btols in (
            (torch.float32, ca.csr_attention.f32_stream, ca.csr_attention, ca.csr_attention_backward, tol,
             (gtol,) * 3),
            (torch.bfloat16, ca.csr_attention.bf16_stream, ca.csr_attention.bf16,
             ca.csr_attention_backward.bf16, bf16_tol, (bf16_tol, bf16_tol, dv_tol))):
        q, k, vv = (t.to(dtype) for t in qkv)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, vv)]
        tc = ca.gather_csr(seg, gather, bounds, m)
        before = counts(stream_counter, fwd_counter, bwd_counter)
        out, ml = ca.csr_attention(*leaves, seg, gather, bounds, m, 0.5, tc, stream_dtype="bf16")
        grads = torch.autograd.grad(out, leaves, g_out.to(dtype))
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(stream_counter, fwd_counter, bwd_counter), before)] == [1, 0, 1]
        assert out.dtype == dtype
        want, want_ml = ca.csr_attention_reference(q, k, vv, seg, gather, n, m, 0.5, stream_dtype="bf16")
        torch.testing.assert_close(out.float(), want.float(), **ftol)
        torch.testing.assert_close(ml, want_ml, **tol)
        want_grads = ca.csr_attention_backward_reference(q, k, vv, seg, gather, ml, out.detach(),
                                                         g_out.to(dtype), m, 0.5)
        for a, b, btol in zip(grads, want_grads, btols):
            torch.testing.assert_close(a.float(), b.float(), **btol)
        base, _ = ca.csr_attention(q, k, vv, seg, gather, bounds, m, 0.5)
        assert not torch.allclose(out.float(), base.float(), **ftol)


def test_stream_refuses_what_no_entry_takes(cuda):
    """The stream entries take what the entries without the stream take: an
    unknown mode or float64 scores raise on the card as on the CPU; a K2
    width that is not a multiple of 32 (D = 48), refused before the general
    geometry, runs against its plain version."""
    from graphphysics_torch.ops import csr_attention as ca

    g, scores, values, mask = _csr_case(128, 500, 64, 4, seed=0, n_pad=128, e_pad=512)
    seg, bounds = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.sender_bounds).to(cuda)
    s, v = scores.to(cuda), values.to(cuda)
    with pytest.raises(ValueError, match="unknown stream_dtype 'f16'"):
        ca.csr_softmax_spmm(s, v, seg, bounds, stream_dtype="f16")
    with pytest.raises(ValueError, match="float32"):
        ca.csr_softmax_spmm(s.double(), v, seg, bounds, stream_dtype="bf16")
    v48, m = v[:, :48].contiguous(), torch.from_numpy(g.edge_mask).to(cuda)
    out, ml = ca.csr_softmax_spmm(s, v48, seg, bounds, m, stream_dtype="bf16")
    want, want_ml = ca.csr_softmax_spmm_reference(ca.stream_round(s), ca.stream_round(v48), seg, g.num_nodes, m)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ml, want_ml, rtol=1e-5, atol=1e-5)

"""Card tests of the port's CUDA kernels: ``csr_segment_sum``,
``csr_softmax_spmm`` and the fused ``csr_attention`` and their backward
kernels against their plain versions on edge cases, autograd through the
wrappers, a TransformerBlock and the EPD and transformer forwards on the
card against the CPU, and two train steps of each model on the card against
the CPU. Marked ``cuda``; they skip without a card. This file imports no JAX, so on a machine without it
run them with

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
    out16 = masked_segment_sum(data.detach().half(), recv, 32, row_bounds=bounds)
    assert out16.dtype == torch.float16


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
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm

    g, scores, values, mask = _csr_case(128, 500, 64, 4, seed=0, n_pad=128, e_pad=512)
    seg = torch.from_numpy(g.senders).to(cuda)
    bounds = torch.from_numpy(g.sender_bounds).to(cuda)
    s, v = scores.to(cuda), values.to(cuda)
    with pytest.raises(ValueError, match="float32"):
        csr_softmax_spmm(s.double(), v, seg, bounds)
    with pytest.raises(ValueError, match="positive multiple of 32"):
        csr_softmax_spmm(s, v[:, :48].contiguous(), seg, bounds)
    with pytest.raises(ValueError, match="at most 512"):
        csr_softmax_spmm(s, torch.zeros(512, 640, device=cuda), seg, bounds)
    with pytest.raises(ValueError, match="head_dim"):
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
     ("two_graphs", 32, 1, "contiguous")],
)
def test_fused_attention_kernels_match_plain(cuda, layout, d, h, view):
    """Both fused kernels against their plain versions, at every lane count
    the geometry allows."""
    from graphphysics_torch.ops import csr_attention as ca

    g, mask, qkv, cot = _fused_case(layout, d, h, seed=d + h)
    seg, gather = torch.from_numpy(g.senders).to(cuda), torch.from_numpy(g.receivers).to(cuda)
    bounds, m = torch.from_numpy(g.sender_bounds).to(cuda), mask.to(cuda)
    q, k, v, g_out = ((_model_view(t) if view == "model" else t).to(cuda) for t in (*qkv, cot))
    interleaved = view == "model" and h > 1
    want_out, want_ml = ca.csr_attention_reference(q, k, v, seg, gather, g.num_nodes, m, 0.5)
    want = ca.csr_attention_backward_reference(q, k, v, seg, gather, want_ml, want_out, g_out, m, 0.5)
    lanes = [n for n in ca.FORWARD_LANES if ca._geometry_ok(n, d, h, interleaved)]
    assert lanes
    for n in lanes:
        _poison_free_memory(cuda)
        before = (ca.csr_attention.launches, ca.csr_attention_backward.launches)
        out, ml = ca._launch_attention(q, k, v, gather, bounds, m, 0.5, interleaved, lanes=n)
        grads = ca._launch_attention_backward(q, k, v, gather, bounds, m, ml, out, g_out, 0.5,
                                              interleaved, lanes=n)
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
    with pytest.raises(ValueError, match="positive multiple of 32"):
        x = torch.zeros(q.shape[0], 4, 12, device=cuda)
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

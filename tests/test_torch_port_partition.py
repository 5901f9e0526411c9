"""The port's edge-partition layouts, reorders, K5's plain versions and the
split-edge overlap, single-process, against the JAX package (twins of the
structure tests of ``tests/test_graph_partition.py`` and
``tests/test_attention_overlap.py``, of ``tests/test_reorder.py``, and of
``test_attention_overlap.py``'s pair-kernel and jaxpr-dependence tests).

- Layouts: ``partition_graph_np``, ``partition_graph_halo_np`` (unsplit and
  split) and ``partition_frames_np`` at P = 2 and 4, with and without
  headroom budgets, against the JAX functions with ``csr=True``: every
  integer array bit for bit, the features equal; the port's per-node
  ``row_bounds`` / ``halo_row_bounds`` against the sorted receivers.
- Reorders: the permutations bit for bit, bijection, relabeling,
  equivariance of the port model, the halo-volume cut.
- K5: ``csr_softmax_spmm_pair`` on the CPU (its plain versions) against the
  JAX ``csr_softmax_spmm_pair`` in TPU interpret mode, forward rtol 1e-5,
  atol 1e-6, both sets' gradients rtol 1e-4, atol 1e-6; and against the
  single ``csr_softmax_spmm_reference`` on the union.
- Overlap: with a recording stand-in for the exchange, split-edge attention
  gathers the local edges before it awaits the exchange; the unsplit layout
  gathers every edge after it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from graphphysics_tpu.core.graph import pad_graph_np as jax_pad_graph_np
from graphphysics_tpu.parallel import graph_partition as jgp
from graphphysics_tpu.parallel import reorder as jre
from graphphysics_tpu.topology.build import face_to_edge
from graphphysics_torch.core.graph import pad_graph_np
from graphphysics_torch.ops.csr_segment import compute_row_bounds
from graphphysics_torch.parallel import graph_partition as gp
from graphphysics_torch.parallel import reorder as re_
from tests import _torch_port_common  # noqa: F401  (thread cap, sync dispatch)
from tests._torch_port_partition_cases import raw_graph

INT_FIELDS = ("senders", "receivers", "edge_mask")
NODE_FIELDS = ("x", "pos", "node_mask", "y")


def graphs(n=256, seed=0):
    raw = raw_graph(n=n, seed=seed)
    return pad_graph_np(**raw), jax_pad_graph_np(**raw)


def check_bounds(bounds, receivers, mask, nl):
    """The port's ranges: every real edge inside its receiver's range, each
    range a run of that receiver's edges."""
    k = int(mask.sum())
    np.testing.assert_array_equal(bounds, compute_row_bounds(receivers, nl, num_real_edges=k))
    assert np.all(mask[:k]) and not np.any(mask[k:])


def same_arrays(port, ref, fields):
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("num_parts", [2, 4])
@pytest.mark.parametrize("headroom", [False, True])
def test_partition_graph_matches_jax(num_parts, headroom):
    port_g, jax_g = graphs(seed=3)
    eb = 1024 if headroom else None
    ours = gp.partition_graph_np(port_g, num_parts, edge_budget_local=eb)
    ref = jgp.partition_graph_np(jax_g, num_parts, edge_budget_local=eb, csr=True)
    same_arrays(ours, ref, INT_FIELDS + NODE_FIELDS + ("edge_attr",))
    assert ours.partition_axis == ref.partition_axis == "graph"
    nl = port_g.num_nodes // num_parts
    for p in range(num_parts):
        check_bounds(ours.row_bounds[p], ours.receivers[p], ours.edge_mask[p], nl)
    np.testing.assert_array_equal(gp.unpartition_rows(ours.x), port_g.x)


@pytest.mark.parametrize("num_parts", [2, 4])
@pytest.mark.parametrize("split", [False, True])
def test_partition_graph_halo_matches_jax(num_parts, split):
    port_g, jax_g = graphs(seed=4)
    ours = gp.partition_graph_halo_np(port_g, num_parts, split_local=split)
    ref = jgp.partition_graph_halo_np(jax_g, num_parts, csr=True, split_local=split)
    same_arrays(ours, ref, INT_FIELDS + NODE_FIELDS + ("edge_attr", "halo_send_idx"))
    assert ours.num_local_edges == ref.num_local_edges
    nl = port_g.num_nodes // num_parts
    for p in range(num_parts):
        if split:
            el = ours.num_local_edges
            check_bounds(ours.row_bounds[p], ours.receivers[p, :el], ours.edge_mask[p, :el], nl)
            check_bounds(ours.halo_row_bounds[p], ours.receivers[p, el:], ours.edge_mask[p, el:], nl)
        else:
            check_bounds(ours.row_bounds[p], ours.receivers[p], ours.edge_mask[p], nl)


def test_split_partition_structure():
    """Every edge once; local senders local, halo senders in the received
    rows, resolving through the send table to the edge's global sender."""
    port_g, _ = graphs()
    parts = gp.partition_graph_halo_np(port_g, 4, split_local=True)
    nl, el, b = 64, parts.num_local_edges, parts.halo_send_idx.shape[2]
    got = set()
    for p in range(4):
        m, s, r = parts.edge_mask[p], parts.senders[p], parts.receivers[p]
        assert (s[:el][m[:el]] < nl).all()
        sh = s[el:][m[el:]]
        assert ((sh >= nl) & (sh < nl + 4 * b)).all()
        for i in np.flatnonzero(m[:el]):
            got.add((int(s[i]) + p * nl, int(r[i]) + p * nl))
        for i in np.flatnonzero(m[el:]):
            q, slot = divmod(int(s[el + i]) - nl, b)
            got.add((int(parts.halo_send_idx[q, p, slot]) + q * nl, int(r[el + i]) + p * nl))
    em = port_g.edge_mask
    assert got == set(zip(port_g.senders[em].tolist(), port_g.receivers[em].tolist()))


@pytest.mark.parametrize("halo,split", [(False, False), (True, False), (True, True)])
def test_partition_frames_matches_jax(halo, split):
    raws = [raw_graph(seed=s) for s in (5, 5, 6)]
    raws[1]["x"] = raws[1]["x"] + 1.0
    ours = gp.partition_frames_np([pad_graph_np(**r) for r in raws], 4, halo=halo,
                                  split_local=split)
    ref = jgp.partition_frames_np([jax_pad_graph_np(**r) for r in raws], 4, halo=halo, csr=True,
                                  split_local=split)
    fields = INT_FIELDS + NODE_FIELDS + (("halo_send_idx",) if halo else ())
    same_arrays(ours, ref, fields)
    assert ours.x.shape[:2] == (3, 4)
    part = gp.part_of(ours, 2, axis=1)
    np.testing.assert_array_equal(part.senders, ours.senders[:, 2])


def grid_mesh(nx=16, ny=16, shuffle=False, seed=0):
    """Both packages' padded graph of a triangulated grid (``test_reorder``'s
    ``_grid_mesh_shuffled``)."""
    n = nx * ny
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    pos = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    faces = []
    for y in range(ny - 1):
        for x in range(nx - 1):
            a, b, c, d = y * nx + x, y * nx + x + 1, (y + 1) * nx + x, (y + 1) * nx + x + 1
            faces += [[a, b, c], [b, d, c]]
    s, r = face_to_edge(np.asarray(faces, np.int64))
    if shuffle:
        relabel = np.random.default_rng(seed).permutation(n)
        s, r = relabel[s], relabel[r]
        pos_new = np.empty_like(pos)
        pos_new[relabel] = pos
        pos = pos_new
    x = np.random.default_rng(seed + 1).normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = 0
    raw = dict(x=x, pos=pos, senders=s.astype(np.int32), receivers=r.astype(np.int32), n_pad=n,
               e_pad=len(s) + 64, edge_attr=np.random.default_rng(seed + 3).normal(
                   size=(len(s), 3)).astype(np.float32),
               y=np.random.default_rng(seed + 2).normal(size=(n, 2)).astype(np.float32),
               node_type_index=2)
    return pad_graph_np(**raw), jax_pad_graph_np(**raw)


@pytest.mark.parametrize("method", ["rcm", "bfs", "hilbert"])
def test_permutation_matches_jax_and_is_bijection(method):
    g, jg = grid_mesh(shuffle=True)
    perm = re_.locality_permutation(g.senders, g.receivers, g.num_nodes, edge_mask=g.edge_mask,
                                    pos=g.pos, method=method)
    ref = jre.locality_permutation(jg.senders, jg.receivers, jg.num_nodes,
                                   edge_mask=jg.edge_mask, pos=jg.pos, method=method)
    np.testing.assert_array_equal(perm, ref)
    assert sorted(perm.tolist()) == list(range(g.num_nodes))
    inv = re_.inverse_permutation(perm)
    np.testing.assert_array_equal(inv, jre.inverse_permutation(ref))
    np.testing.assert_array_equal(perm[inv], np.arange(g.num_nodes))


def test_permute_graph_matches_jax_and_relabels():
    g, jg = grid_mesh()
    perm = re_.locality_permutation(g.senders, g.receivers, g.num_nodes, edge_mask=g.edge_mask)
    pg, jpg = re_.permute_graph_np(g, perm), jre.permute_graph_np(jg, perm)
    same_arrays(pg, jpg, INT_FIELDS + NODE_FIELDS)
    assert pg.row_bounds is None and pg.sender_bounds is None
    inv = re_.inverse_permutation(perm)
    np.testing.assert_array_equal(pg.x[inv], g.x)
    np.testing.assert_array_equal(pg.x[pg.senders], g.x[g.senders])


def test_model_forward_equivariance():
    from graphphysics_torch.models import EncodeProcessDecode

    g, _ = grid_mesh()
    model = EncodeProcessDecode(2, 4, 3, 2, 16)
    perm = re_.locality_permutation(g.senders, g.receivers, g.num_nodes, edge_mask=g.edge_mask)
    with torch.no_grad():
        ref = model(g.to("cpu")).numpy()
        out = model(re_.permute_graph_np(g, perm).to("cpu")).numpy()
    np.testing.assert_allclose(out, ref[perm], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("num_parts", [4, 8])
def test_rcm_cuts_the_halo_volume_as_jax(num_parts):
    g, jg = grid_mesh(nx=32, ny=32, shuffle=True)
    before = re_.halo_volume(g, num_parts)
    assert before == jre.halo_volume(jg, num_parts)
    perm = re_.locality_permutation(g.senders, g.receivers, g.num_nodes, edge_mask=g.edge_mask)
    after = re_.halo_volume(re_.permute_graph_np(g, perm), num_parts)
    assert after["rows_exchanged_real"] < 0.2 * before["rows_exchanged_real"]
    assert after["real_fraction"] < 0.35
    with pytest.raises(ValueError, match="not divisible"):
        re_.halo_volume(g, 7)


def pair_inputs(seed, n=128, h=4, dh=8, ea=300, eb=90, masked=False):
    r = np.random.default_rng(seed)
    d = h * dh
    seg_a = np.sort(r.integers(0, n, ea)).astype(np.int32)
    seg_b = np.sort(r.integers(0, n, eb)).astype(np.int32)
    sc_a = r.normal(size=(ea, h)).astype(np.float32)
    sc_b = r.normal(size=(eb, h)).astype(np.float32)
    va = r.normal(size=(ea, d)).astype(np.float32)
    vb = r.normal(size=(eb, d)).astype(np.float32)
    ma = np.ones(ea, bool)
    mb = np.ones(eb, bool)
    if masked:
        ma[::7] = False
        mb[::5] = False
    w = r.normal(size=(n, d)).astype(np.float32)
    return n, (sc_a, va, seg_a, ma), (sc_b, vb, seg_b, mb), w


def jax_pair(n, a, b, w):
    """The JAX pair function (interpret mode) and its gradients, masked
    edges handed over as ``csr_sparse_attention`` hands them (score -1e30,
    segment N)."""
    from graphphysics_tpu.ops.pallas_attention import compute_block_bounds, csr_softmax_spmm_pair

    def prep(s, v, seg, m):
        bounds = compute_block_bounds(seg, n, num_real_edges=len(seg))
        return (jnp.asarray(np.where(m[:, None], s, -1e30)), jnp.asarray(v),
                jnp.asarray(np.where(m, seg, n).astype(np.int32)), jnp.asarray(bounds))

    (sa, va, ga, ba), (sb, vb, gb, bb) = prep(*a), prep(*b)

    def f(sa, va, sb, vb):
        return jnp.sum(csr_softmax_spmm_pair(sa, va, ga, ba, sb, vb, gb, bb, n) * w)

    with pltpu.force_tpu_interpret_mode():
        out = csr_softmax_spmm_pair(sa, va, ga, ba, sb, vb, gb, bb, n)
        grads = jax.grad(f, argnums=(0, 1, 2, 3))(sa, va, sb, vb)
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_pair(n, a, b, w):
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm_pair

    def prep(s, v, seg, m):
        return (torch.tensor(s, requires_grad=True), torch.tensor(v, requires_grad=True),
                torch.from_numpy(seg), torch.from_numpy(compute_row_bounds(seg, n)),
                torch.from_numpy(m))

    (sa, va, ga, ba, ma), (sb, vb, gb, bb, mb) = prep(*a), prep(*b)
    out, ml = csr_softmax_spmm_pair(sa, va, ga, ba, sb, vb, gb, bb, ma, mb)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (sa, va, sb, vb))
    return out.detach().numpy(), ml.numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("masked", [False, True])
def test_pair_plain_versions_match_jax_pair(masked):
    n, a, b, w = pair_inputs(0, masked=masked)
    out, _, grads = port_pair(n, a, b, w)
    want, want_grads = jax_pair(n, a, b, w)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    for got, ref, m in zip(grads, want_grads, (a[3], a[3], b[3], b[3])):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
        assert np.all(got[~m] == 0)


def test_pair_plain_versions_match_single_on_the_union():
    from graphphysics_torch.ops.csr_attention import csr_softmax_spmm_reference

    n, a, b, w = pair_inputs(1)
    out, ml, grads = port_pair(n, a, b, w)
    seg = np.concatenate([a[2], b[2]])
    order = np.argsort(seg, kind="stable")
    s_u = torch.tensor(np.concatenate([a[0], b[0]])[order], requires_grad=True)
    v_u = torch.tensor(np.concatenate([a[1], b[1]])[order], requires_grad=True)
    ref, ref_ml = csr_softmax_spmm_reference(s_u, v_u, torch.from_numpy(seg[order]), n)
    np.testing.assert_allclose(out, ref.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ml, ref_ml.numpy(), rtol=1e-5, atol=1e-6)
    gs, gv = torch.autograd.grad((ref * torch.from_numpy(w)).sum(), (s_u, v_u))
    inv = np.argsort(order)
    gs, gv = gs.numpy()[inv], gv.numpy()[inv]
    ea = len(a[2])
    for got, ref_g in zip(grads, (gs[:ea], gv[:ea], gs[ea:], gv[ea:])):
        np.testing.assert_allclose(got, ref_g, rtol=1e-4, atol=1e-6)


class Recorder:
    """A stand-in for the exchange, and wrappers of the gathers, that record
    their order as ``("gather", module, rows)``, ``("start",)`` and
    ``("wait",)``: the exchange ships ``send`` back to itself (one rank's
    view; the values do not matter here)."""

    def __init__(self, monkeypatch):
        from graphphysics_torch.ops import attention, halo

        self.events = []
        recorder = self

        def recording(module):
            real = module.take_rows

            def take(x, idx):
                recorder.events.append(("gather", module.__name__, int(idx.shape[0])))
                return real(x, idx)

            return take

        class Pending:
            def __init__(self, send):
                self.send = send

            def wait(self):
                recorder.events.append(("wait",))
                return self.send.clone()

        def exchange(send, axis_name, async_op=False):
            recorder.events.append(("start",))
            return Pending(send)

        monkeypatch.setattr(attention, "take_rows", recording(attention))
        monkeypatch.setattr(halo, "take_rows", recording(halo))
        monkeypatch.setattr(halo, "exchange", exchange)


@pytest.mark.parametrize("split", [True, False])
def test_local_attention_gathers_run_before_the_exchange_is_awaited(monkeypatch, split):
    from graphphysics_torch.ops.attention import sparse_graph_attention

    port_g, _ = graphs(seed=7)
    part = gp.partition_graph_halo_np(port_g, 2, split_local=split)[0].to("cpu")
    rec = Recorder(monkeypatch)
    n, e = part.num_nodes, part.num_edges
    q, k, v = torch.randn(3, n, 4, 4).unbind(0)
    sparse_graph_attention(
        q, k, v, part.senders, part.receivers, n, edge_mask=part.edge_mask,
        row_bounds=part.row_bounds, partition_axis="graph", halo_send_idx=part.halo_send_idx,
        halo_row_bounds=part.halo_row_bounds, num_local_edges=part.num_local_edges)
    events = rec.events
    assert events.count(("start",)) == events.count(("wait",)) == 1
    start, wait = events.index(("start",)), events.index(("wait",))
    gathers = [(i, ev[1].rsplit(".", 1)[-1], ev[2]) for i, ev in enumerate(events)
               if ev[0] == "gather"]
    # the rows sent: gathered from node rows before the exchange starts
    sends = [i for i, mod, rows in gathers if mod == "halo" and i < start]
    assert len(sends) == 1
    edge = [(i, rows) for i, mod, rows in gathers if i not in sends]
    if split:
        el = part.num_local_edges
        assert [rows for _, rows in edge] == [el, el, e - el, e - el]
        assert all(start < i < wait for i, _ in edge[:2])  # local: under the exchange
        assert all(i > wait for i, _ in edge[2:])
    else:
        assert [rows for _, rows in edge] == [e, e]
        assert all(i > wait for i, _ in edge)  # every edge gather after it

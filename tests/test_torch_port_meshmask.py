"""Port twins of ``tests/test_meshmask.py``
(``graphphysics_torch/utils/meshmask.py``), and the port against the JAX
functions on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import torch

from graphphysics_tpu.core.graph import Graph as JaxGraph
from graphphysics_tpu.utils import meshmask as jax_meshmask
from graphphysics_torch.core.graph import pad_graph_np
from graphphysics_torch.utils.meshmask import (
    build_masked_graph,
    reconstruct_graph,
    visible_edge_mask,
)
from tests import _torch_port_common  # noqa: F401  (caps torch's threads)


def _graph(seed=0, n=48, e=160):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    return pad_graph_np(x, r.normal(size=(n, 2)).astype(np.float32),
                        r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32),
                        n_pad=64, e_pad=192, edge_attr=r.normal(size=(e, 3)).astype(np.float32),
                        y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2).to("cpu")


def test_visible_edge_mask_drops_hidden_endpoints(rng):
    g = _graph()
    keep = torch.from_numpy(rng.random(g.num_nodes) > 0.3)
    em = visible_edge_mask(g, keep).numpy()
    s, r, k = g.senders.numpy(), g.receivers.numpy(), keep.numpy()
    np.testing.assert_array_equal(em, k[s] & k[r] & g.edge_mask.numpy())


def test_build_masked_graph_masks_nodes_and_edges(rng):
    g = _graph()
    keep = torch.from_numpy(rng.random(g.num_nodes) > 0.3)
    masked, edges_visible = build_masked_graph(g, keep)
    assert masked.x.shape == g.x.shape  # padded shapes kept
    np.testing.assert_array_equal(masked.node_mask.numpy(), (g.node_mask & keep).numpy())
    np.testing.assert_array_equal(masked.edge_mask.numpy(), edges_visible.numpy())


def _reconstruct_inputs(g, rng):
    f, fe = g.x.shape[1], g.edge_attr.shape[1]
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))  # noqa: E731
    keep = torch.from_numpy(rng.random(g.num_nodes) > 0.5)
    return keep, t(g.num_nodes, f), t(f), t(g.num_edges, fe), t(g.num_edges, fe), t(fe)


def test_reconstruct_substitutes_mask_tokens(rng):
    g = _graph()
    keep, latent, token, latent_ea, encoded_raw, e_token = _reconstruct_inputs(g, rng)
    _, edges_visible = build_masked_graph(g, keep)
    out = reconstruct_graph(g, latent, keep, token, edges_visible=edges_visible,
                            latent_edge_attr=latent_ea, encoded_raw_edge_attr=encoded_raw,
                            edge_mask_token=e_token)
    k = keep.numpy()
    np.testing.assert_allclose(out.x.numpy()[k], latent.numpy()[k])
    np.testing.assert_allclose(out.x.numpy()[~k], np.tile(token.numpy(), (int((~k).sum()), 1)))
    ev = edges_visible.numpy()
    np.testing.assert_allclose(out.edge_attr.numpy()[ev], latent_ea.numpy()[ev])
    np.testing.assert_allclose(out.edge_attr.numpy()[~ev], encoded_raw.numpy()[~ev] + e_token.numpy(),
                               rtol=1e-6)


def test_meshmask_equals_the_jax_functions(rng):
    g = _graph(seed=3)
    jg = JaxGraph(x=jnp.asarray(g.x.numpy()), pos=jnp.asarray(g.pos.numpy()),
                  senders=jnp.asarray(g.senders.numpy()), receivers=jnp.asarray(g.receivers.numpy()),
                  edge_attr=jnp.asarray(g.edge_attr.numpy()), node_mask=jnp.asarray(g.node_mask.numpy()),
                  edge_mask=jnp.asarray(g.edge_mask.numpy()), y=jnp.asarray(g.y.numpy()))
    keep, latent, token, latent_ea, encoded_raw, e_token = _reconstruct_inputs(g, rng)
    masked, ev = build_masked_graph(g, keep)
    jmasked, jev = jax_meshmask.build_masked_graph(jg, jnp.asarray(keep.numpy()))
    np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
    np.testing.assert_array_equal(masked.node_mask.numpy(), np.asarray(jmasked.node_mask))
    out = reconstruct_graph(g, latent, keep, token, ev, latent_ea, encoded_raw, e_token)
    jout = jax_meshmask.reconstruct_graph(jg, *(jnp.asarray(t.numpy()) for t in (latent, keep, token)),
                                          jev, *(jnp.asarray(t.numpy()) for t in (latent_ea, encoded_raw, e_token)))
    np.testing.assert_array_equal(out.x.numpy(), np.asarray(jout.x))
    np.testing.assert_array_equal(out.edge_attr.numpy(), np.asarray(jout.edge_attr))

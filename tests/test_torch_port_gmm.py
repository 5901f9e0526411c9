"""Port parity, Gaussian-mixture heads: the pure sampling functions against
the JAX samplers fed the same draws (made from a JAX key with the JAX
sampler's own split, categorical and normal), the torch samplers'
statistics, both negative log-likelihoods and ``make_local_loss`` against
JAX (values and gradients), the heads and the Simulator's eval at K = 1 with
temperature 0 (deterministic) and its rollout against JAX, the config keys,
and JAX GMM weights loading into the port with ``strict=True``. Torch twins
of ``test_gmm.py``, ``test_losses.py`` (GMM), ``test_simulator.py`` (GMM),
``test_layers.py`` (GMM head), ``test_parse_parameters.py`` (GMM) and
``test_torch_import.py`` (GMM head). Everything runs on the CPU; inputs come
from numpy with a seed."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core.graph import Graph as JaxGraph
from graphphysics_tpu.models import gmm as jax_gmm
from graphphysics_tpu.models.processors import EncodeProcessDecode as JaxEPD
from graphphysics_tpu.models.processors import EncodeTransformDecode as JaxETD
from graphphysics_tpu.models.simulator import Simulator as JaxSim
from graphphysics_tpu.models.simulator import SimulatorConfig as JaxCfg
from graphphysics_tpu.training import losses as jax_losses
from graphphysics_tpu.training.rollout import jitted_rollout
from graphphysics_tpu.utils.torch_import import export_reference_checkpoint, export_reference_state_dict
from graphphysics_torch.core import NodeType
from graphphysics_torch.core.graph import pad_graph_csr_np, pad_graph_sorted_np, stack_graphs
from graphphysics_torch.models import (
    DiagonalGMMHead,
    EncodeProcessDecode,
    EncodeTransformDecode,
    GMMHead,
    Simulator,
    SimulatorConfig,
    gmm_diagonal_from_draws,
    gmm_full_from_draws,
    sample_gmm,
    sample_gmm_diagonal,
)
from graphphysics_torch.models.gmm import components, draw_gmm
from graphphysics_torch.training import (
    diagonal_gmm_nll_loss,
    get_model,
    gmm_nll_loss,
    make_local_loss,
    rollout,
)
from graphphysics_torch.utils.reference_weights import load_reference_checkpoint
from tests._torch_port_common import CYLINDER_INDEX

# the samplers fed equal draws: a gather, exp and one multiply-add (diagonal)
# or a d x d product (full) in f32
SAMPLE_RTOL, SAMPLE_ATOL = 1e-6, 1e-6
# NLL values and gradients: exp, log, logsumexp and (full) a triangular
# solve in f32 in another order
NLL_RTOL, NLL_ATOL = 1e-5, 1e-5
# the Simulator's eval and rollout: f32 through 2 blocks in another order
# (XLA vs ATen), then the output normalizer's inverse
EVAL_RTOL, EVAL_ATOL = 1e-4, 1e-4
MASKS = [int(NodeType.NORMAL), int(NodeType.OUTFLOW)]


def _jax_draws(key, logits, n, d):
    """The draws of the JAX samplers for ``key``: their own split,
    categorical and normal."""
    k_rng, z_rng = jax.random.split(key)
    comp = jax.random.categorical(k_rng, jnp.asarray(logits), axis=-1)
    z = jax.random.normal(z_rng, (n, d), dtype=jnp.float32)
    return torch.from_numpy(np.array(comp)), torch.from_numpy(np.array(z))


@pytest.mark.parametrize("temperature", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("kind", ["diagonal", "full"])
def test_pure_samplers_match_jax_on_its_draws(kind, temperature):
    n, d, K = 64, 3, 4
    per = 2 * d + 1 if kind == "diagonal" else 1 + d + d * (d + 1) // 2
    net = np.random.default_rng(0).normal(size=(n, K * per)).astype(np.float32)
    key = jax.random.key(7)
    jax_fn = jax_gmm.sample_gmm_diagonal if kind == "diagonal" else jax_gmm.sample_gmm
    want = np.asarray(jax_fn(key, jnp.asarray(net), d=d, K=K, temperature=temperature))
    comp, z = _jax_draws(key, net.reshape(n, K, per)[..., 0], n, d)
    fn = gmm_diagonal_from_draws if kind == "diagonal" else gmm_full_from_draws
    got = fn(torch.from_numpy(net), comp, z, d, K, temperature).numpy()
    np.testing.assert_allclose(got, want, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)


def test_diagonal_sampler_shapes_and_temperature_zero():
    """Twin of ``test_diagonal_sampler_shapes_and_temperature_zero``: at
    temperature 0 each row is exactly one of its component means."""
    n, d, K = 32, 3, 4
    net = np.random.default_rng(1).normal(size=(n, K * (2 * d + 1))).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    assert sample_gmm_diagonal(torch.from_numpy(net), d, K, 1.0, gen).shape == (n, d)
    out0 = sample_gmm_diagonal(torch.from_numpy(net), d, K, 0.0, gen).numpy()
    means = net.reshape(n, K, 2 * d + 1)[..., 1 : 1 + d]
    for i in range(n):
        assert np.abs(means[i] - out0[i]).max(axis=-1).min() == 0.0


def test_diagonal_sampler_single_component_statistics():
    n, d = 4000, 2
    mean = np.array([1.5, -2.0], np.float32)
    log_std = np.log(np.array([0.5, 2.0], np.float32))
    net = np.concatenate([np.zeros((n, 1)), np.tile(mean, (n, 1)), np.tile(log_std, (n, 1))],
                         axis=1).astype(np.float32)
    out = sample_gmm_diagonal(torch.from_numpy(net), d, 1, 1.0, torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_allclose(out.mean(axis=0), mean, atol=0.15)
    np.testing.assert_allclose(out.std(axis=0), np.exp(log_std), atol=0.15)


def test_full_sampler_matches_cholesky_covariance():
    n, d = 6000, 2
    mean = np.array([0.5, 1.0], np.float32)
    L = np.array([[1.0, 0.0], [0.8, 0.6]], np.float32)
    tril = np.array([L[0, 0], L[1, 0], L[1, 1]], np.float32)
    net = np.concatenate([np.zeros((n, 1)), np.tile(mean, (n, 1)), np.tile(tril, (n, 1))],
                         axis=1).astype(np.float32)
    out = sample_gmm(torch.from_numpy(net), d, 1, 1.0, torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_allclose(out.mean(axis=0), mean, atol=0.1)
    np.testing.assert_allclose(np.cov(out.T), L @ L.T, atol=0.15)


def test_sampler_statistics_three_components():
    """K = 3: component frequencies against softmax(logits), and each
    component's mean and std, within 5 standard errors."""
    n, d, K = 60000, 2, 3
    logits = np.array([0.3, -0.4, 1.1], np.float32)
    means = np.array([[-3.0, 1.0], [0.0, 4.0], [3.0, -2.0]], np.float32)
    stds = np.array([[0.5, 1.0], [0.3, 0.2], [1.5, 0.7]], np.float32)
    comp = np.concatenate([logits[:, None], means, np.log(stds)], axis=1)  # [K, 2d+1]
    net = np.tile(comp.reshape(1, -1), (n, 1))
    gen = torch.Generator().manual_seed(11)
    gumbel, z = draw_gmm(n, K, d, torch.Generator().manual_seed(11))
    ids = components(torch.from_numpy(logits).expand(n, K), gumbel).numpy()
    out = sample_gmm_diagonal(torch.from_numpy(net), d, K, 1.0, gen).numpy()
    alpha = np.exp(logits) / np.exp(logits).sum()
    freq = np.bincount(ids, minlength=K) / n
    assert np.all(np.abs(freq - alpha) <= 5 * np.sqrt(alpha * (1 - alpha) / n)), (freq, alpha)
    for k in range(K):
        rows = out[ids == k]
        m = len(rows)
        assert np.all(np.abs(rows.mean(axis=0) - means[k]) <= 5 * stds[k] / np.sqrt(m))
        assert np.all(np.abs(rows.std(axis=0) - stds[k]) <= 5 * stds[k] / np.sqrt(2 * m))


def test_sampler_draws_from_the_generator_only():
    """Equal generator seeds give equal samples; the global random state is
    neither read nor advanced."""
    net = torch.from_numpy(np.random.default_rng(2).normal(size=(50, 3 * 5)).astype(np.float32))
    before = torch.random.get_rng_state()
    a = sample_gmm_diagonal(net, 2, 3, 1.0, torch.Generator().manual_seed(4))
    b = sample_gmm_diagonal(net, 2, 3, 1.0, torch.Generator().manual_seed(4))
    c = sample_gmm_diagonal(net, 2, 3, 1.0, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(torch.random.get_rng_state(), before)


# ---------------------------------------------------------------- losses


def _nll_inputs(kind, seed, n=30, d=2, K=3):
    r = np.random.default_rng(seed)
    per = 2 * d + 1 if kind == "diag" else 1 + d + d * (d + 1) // 2
    target = r.normal(size=(n, d)).astype(np.float32)
    net = r.normal(size=(n, K * per)).astype(np.float32)
    if kind == "full":  # keep the Cholesky diagonals away from 0, one row degenerate
        rows = net.reshape(n, K, per)
        for i in range(d):
            rows[..., 1 + d + i * (i + 1) // 2 + i] = 0.5 + r.random((n, K))
        rows[0, 0, 1 + d] = 0.0
    node_type = r.integers(0, 7, n).astype(np.int32)
    valid = r.random(n) > 0.2
    return target, net, node_type, valid


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("kind", ["diag", "full"])
def test_nll_and_its_gradient_match_jax(kind, temperature):
    d, K = 2, 3
    target, net, node_type, valid = _nll_inputs(kind, seed=3)
    jax_fn = jax_losses.diagonal_gmm_nll_loss if kind == "diag" else jax_losses.gmm_nll_loss
    fn = diagonal_gmm_nll_loss if kind == "diag" else gmm_nll_loss

    def jax_loss(t, o):
        return jax_fn(t, o, jnp.asarray(node_type), MASKS, d=d, K=K, temperature=temperature,
                      node_valid=jnp.asarray(valid))

    want, want_grads = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(target), jnp.asarray(net))
    t, o = (torch.from_numpy(a).requires_grad_(True) for a in (target, net))
    got = fn(t, o, torch.from_numpy(node_type), MASKS, d=d, K=K, temperature=temperature,
             node_valid=torch.from_numpy(valid))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=NLL_RTOL)
    for g, w in zip((t.grad, o.grad), want_grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=NLL_RTOL, atol=NLL_ATOL)


def _dense_diag_nll(target, net, node_type, masks, d, K, temp):
    """The diagonal NLL in numpy f64, as ``test_losses.py`` writes it."""
    n = net.shape[0]
    net3 = net.reshape(n, K, 2 * d + 1).astype(np.float64)
    logit, means, log_std = net3[..., 0], net3[..., 1 : 1 + d], net3[..., 1 + d :]
    alpha = np.exp(logit - logit.max(-1, keepdims=True))
    alpha = alpha / alpha.sum(-1, keepdims=True)
    std = np.exp(log_std) * temp
    diff = target[:, None, :] - means
    log_comp = -0.5 * (2 * np.log(std + 1e-12) + diff**2 / (std**2 + 1e-12) + np.log(2 * np.pi))
    lm = np.log(alpha + 1e-12) + log_comp.sum(-1)
    mx = lm.max(-1, keepdims=True)
    lse = mx[:, 0] + np.log(np.exp(lm - mx).sum(-1))
    keep = np.isin(node_type, masks)
    return -lse[keep].mean()


def test_diag_gmm_nll_matches_dense():
    d, K, n = 2, 3, 30
    r = np.random.default_rng(4)
    target = r.normal(size=(n, d)).astype(np.float32)
    net = r.normal(size=(n, K * (2 * d + 1))).astype(np.float32)
    node_type = r.integers(0, 7, n).astype(np.int32)
    got = diagonal_gmm_nll_loss(torch.from_numpy(target), torch.from_numpy(net),
                                torch.from_numpy(node_type), MASKS, d=d, K=K, temperature=1.0)
    np.testing.assert_allclose(got.item(), _dense_diag_nll(target, net, node_type, MASKS, d, K, 1.0),
                               rtol=1e-4)


def test_full_gmm_nll_finite_and_equal_to_diag_when_diagonal():
    """Twins of ``test_full_gmm_nll_finite_and_reasonable`` and
    ``test_full_gmm_nll_matches_diag_when_diagonal``; also a padded all-zero
    row stays finite (the guard before the solve)."""
    d, K, n = 3, 2, 25
    r = np.random.default_rng(5)
    net = r.normal(size=(n, K * (1 + d + 6))).astype(np.float32)
    net[-3:] = 0.0  # padding rows: a zero Cholesky factor
    zeros = torch.zeros(n, dtype=torch.int32)
    full = gmm_nll_loss(torch.from_numpy(r.normal(size=(n, d)).astype(np.float32)),
                        torch.from_numpy(net), zeros, [int(NodeType.NORMAL)], d=d, K=K)
    assert np.isfinite(full.item())

    d, K, n = 2, 2, 20
    target = r.normal(size=(n, d)).astype(np.float32)
    logit = r.normal(size=(n, K, 1)).astype(np.float32)
    means = r.normal(size=(n, K, d)).astype(np.float32)
    diag = (0.5 + r.random((n, K, d))).astype(np.float32)
    tril = np.zeros((n, K, 3), np.float32)
    tril[..., 0], tril[..., 2] = diag[..., 0], diag[..., 1]
    full_net = np.concatenate([logit, means, tril], axis=-1).reshape(n, -1)
    diag_net = np.concatenate([logit, means, np.log(diag)], axis=-1).reshape(n, -1)
    zeros = torch.zeros(n, dtype=torch.int32)
    a = gmm_nll_loss(torch.from_numpy(target), torch.from_numpy(full_net), zeros,
                     [int(NodeType.NORMAL)], d=d, K=K)
    b = diagonal_gmm_nll_loss(torch.from_numpy(target), torch.from_numpy(diag_net), zeros,
                              [int(NodeType.NORMAL)], d=d, K=K)
    np.testing.assert_allclose(a.item(), b.item(), rtol=1e-3)


@pytest.mark.parametrize("kind", ["l2", "diag_gmm", "full_gmm"])
def test_make_local_loss_matches_jax(kind):
    """The (sum, count) local loss of every kind against JAX's, values and
    the sum's gradient; its sum over two halves is the masked mean's
    numerator (the microbatch parity of ``test_microbatch.py``)."""
    d, K = 2, 3
    target, net, node_type, valid = _nll_inputs("full" if kind == "full_gmm" else "diag", seed=6)
    if kind == "l2":
        net = net[:, :d].copy()
    exclude = np.random.default_rng(7).random(len(target)) > 0.8
    gmm_kwargs = None if kind == "l2" else dict(d=d, K=K, temperature=1.0)
    jax_local = jax_losses.make_local_loss(MASKS, kind, gmm_kwargs)

    def jax_sum(o):
        return jax_local(jnp.asarray(target), o, jnp.asarray(node_type), jnp.asarray(valid),
                         jnp.asarray(exclude))[0]

    want_sum, want_count = jax_local(jnp.asarray(target), jnp.asarray(net), jnp.asarray(node_type),
                                     jnp.asarray(valid), jnp.asarray(exclude))
    want_grad = jax.grad(jax_sum)(jnp.asarray(net))
    local = make_local_loss(MASKS, kind, gmm_kwargs)
    args = [torch.from_numpy(a) for a in (node_type, valid, exclude)]
    o = torch.from_numpy(net).requires_grad_(True)
    got_sum, got_count = local(torch.from_numpy(target), o, *args)
    got_sum.backward()
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=NLL_RTOL)
    assert got_count.item() == float(want_count)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(want_grad), rtol=NLL_RTOL, atol=NLL_ATOL)
    halves = [local(torch.from_numpy(target[s]), torch.from_numpy(net[s]), *(a[s] for a in args))
              for s in (slice(0, 15), slice(15, None))]
    np.testing.assert_allclose(sum(h[0].item() for h in halves), got_sum.item(), rtol=1e-6)
    with pytest.raises(ValueError):
        make_local_loss(MASKS, "nope")


# ---------------------------------------------------------------- models


def _graph(kind, seed=0, n=50, e=170, n_pad=128, e_pad=192):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, 4)).astype(np.float32)
    x[:, 2] = r.integers(0, 7, n)
    pad = pad_graph_sorted_np if kind == "epd" else pad_graph_csr_np
    return pad(
        x, r.normal(size=(n, 2)).astype(np.float32),
        r.integers(0, n, e).astype(np.int32), r.integers(0, n, e).astype(np.int32),
        n_pad, e_pad, edge_attr=r.normal(size=(e, 3)).astype(np.float32) if kind == "epd" else None,
        y=r.normal(size=(n, 2)).astype(np.float32), node_type_index=2,
    )


def _jax_graph(g):
    return JaxGraph(
        x=jnp.asarray(g.x), pos=jnp.asarray(g.pos), senders=jnp.asarray(g.senders),
        receivers=jnp.asarray(g.receivers),
        edge_attr=None if g.edge_attr is None else jnp.asarray(g.edge_attr),
        node_mask=jnp.asarray(g.node_mask), edge_mask=jnp.asarray(g.edge_mask), y=jnp.asarray(g.y),
    )


def _sim_pair(kind, K, temperature, use_diagonal, blocks=2, hidden=16):
    """(jax Simulator, port Simulator on the CPU) with a GMM head."""
    node_in = 2 + int(NodeType.SIZE)
    edge_in = 3 if kind == "epd" else 0
    gmm = dict(num_mixture_components=K, temperature=temperature, use_diagonal=use_diagonal)
    if kind == "epd":
        jax_model = JaxEPD(message_passing_num=blocks, node_input_size=node_in, edge_input_size=3,
                           output_size=2, hidden_size=hidden, **gmm)
        model = EncodeProcessDecode(blocks, node_in, 3, 2, hidden, **gmm)
    else:
        jax_model = JaxETD(message_passing_num=blocks, node_input_size=node_in, output_size=2,
                           hidden_size=hidden, num_heads=4, **gmm)
        model = EncodeTransformDecode(blocks, node_in, 2, hidden, 4, **gmm)
    jax_sim = JaxSim(config=JaxCfg(node_input_size=node_in, edge_input_size=edge_in, output_size=2,
                                   **CYLINDER_INDEX), model=jax_model)
    sim = Simulator(SimulatorConfig(node_input_size=node_in, edge_input_size=edge_in, output_size=2,
                                    **CYLINDER_INDEX), model, device="cpu")
    return jax_sim, sim


def _carried(jax_sim, sim, jgraphs):
    """JAX variables with statistics of ``jgraphs``, loaded into ``sim``."""
    variables = jax_sim.init({"params": jax.random.key(0), "sample": jax.random.key(1)}, jgraphs[0])
    for jg in jgraphs:
        _, mut = jax_sim.apply(variables, jg, method=JaxSim.accumulate_stats, mutable=["normalizer"])
        variables = {"params": variables["params"], "normalizer": mut["normalizer"]}
    load_reference_checkpoint(sim, export_reference_checkpoint(variables))
    return variables


@pytest.mark.parametrize("use_diagonal", [True, False])
@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_simulator_eval_k1_temperature0_matches_jax(kind, use_diagonal):
    """K = 1 and temperature 0: the sample is the single component's mean,
    so the JAX and port evals agree with no shared draws; the head's raw
    output too."""
    jax_sim, sim = _sim_pair(kind, K=1, temperature=0.0, use_diagonal=use_diagonal)
    g = _graph(kind, seed=1)
    variables = _carried(jax_sim, sim, [_jax_graph(g)])
    want = jax_sim.apply(variables, _jax_graph(g), is_training=False, rngs={"sample": jax.random.key(2)})
    with torch.no_grad():
        got = sim(g.to("cpu"), generator=torch.Generator().manual_seed(3))
    per = 5 if use_diagonal else 6
    assert got[0].shape == (g.num_nodes, per)
    for name, ours, theirs in zip(("network_output", "target_delta", "outputs"), got, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=EVAL_RTOL, atol=EVAL_ATOL,
                                   err_msg=name)


def test_rollout_k1_temperature0_matches_jax():
    jax_sim, sim = _sim_pair("transformer", K=1, temperature=0.0, use_diagonal=True)
    graphs = [_graph("transformer", seed=s) for s in range(4)]
    jframes = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[_jax_graph(g) for g in graphs])
    variables = _carried(jax_sim, sim, [_jax_graph(g) for g in graphs])
    want_p, want_t = jitted_rollout(jax_sim, variables, jframes, jax.random.key(0))
    preds, targets = rollout(sim, stack_graphs(graphs), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(targets.numpy(), np.asarray(want_t))
    np.testing.assert_allclose(preds.numpy(), np.asarray(want_p), rtol=EVAL_RTOL, atol=EVAL_ATOL)


@pytest.mark.parametrize("use_diagonal", [True, False])
def test_eval_gmm_sampling_shapes_and_generator(use_diagonal):
    """Twins of ``test_eval_gmm_sampling_shapes`` and
    ``test_eval_full_covariance_gmm_sampling``: K = 3 heads emit K * per
    columns, samples are finite, equal generator seeds give equal outputs,
    and eval without a generator raises."""
    _, sim = _sim_pair("epd", K=3, temperature=1.0, use_diagonal=use_diagonal)
    g = _graph("epd", seed=2).to("cpu")
    sim.accumulate_stats(g)
    with torch.no_grad():
        raw, _, a = sim(g, generator=torch.Generator().manual_seed(7))
        b = sim(g, generator=torch.Generator().manual_seed(7))[2]
        c = sim(g, generator=torch.Generator().manual_seed(8))[2]
        with pytest.raises(ValueError, match="generator"):
            sim(g)
    assert raw.shape == (g.num_nodes, 3 * (5 if use_diagonal else 6))
    assert a.shape == (g.num_nodes, 2) and torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_eval_gmm_temperature_zero_is_deterministic():
    """Twin of ``test_eval_gmm_temperature_zero_is_deterministic``: at
    temperature 0 the output is a component mean whatever the generator,
    and 0.0 is not read as 1.0."""
    _, sim = _sim_pair("epd", K=1, temperature=0.0, use_diagonal=True)
    g = _graph("epd", seed=3).to("cpu")
    sim.accumulate_stats(g)
    with torch.no_grad():
        a = sim(g, generator=torch.Generator().manual_seed(1))[2]
        b = sim(g, generator=torch.Generator().manual_seed(2))[2]
    assert sim.model.temperature == 0.0
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["epd", "transformer"])
def test_gmm_head_output_size_and_names(kind):
    """Twin of ``test_epd_gmm_head_output_size``; the head's modules are
    ``decode_module.pre_proj`` and ``decode_module.proj``."""
    d, K = 2, 3
    model = (EncodeProcessDecode(1, 11, 3, d, 16, num_mixture_components=K) if kind == "epd"
             else EncodeTransformDecode(1, 11, d, 16, 4, num_mixture_components=K))
    assert isinstance(model.decode_module, DiagonalGMMHead) and (model.d, model.K) == (d, K)
    x = torch.randn(10, 16)
    assert model.decode_module(x).shape == (10, K * (2 * d + 1))
    names = {n for n, _ in model.decode_module.named_parameters()}
    assert names == {"pre_proj.weight", "pre_proj.bias", "proj.weight", "proj.bias"}
    full = GMMHead(16, d, K)
    assert full(x).shape == (10, K * (1 + d + d * (d + 1) // 2)) and full(x).dtype == torch.float32


def test_get_model_reads_the_gmm_keys():
    """Twin of ``test_get_model_gmm_and_precision``: the GMM keys are read
    (temperature None stays None and reads as 1.0 where it is used; 0.0 is
    kept); with ``"precision": "bf16"`` the GMM head computes its
    ``pre_proj`` in bf16 and returns f32."""
    param = {"model": {"type": "epd", "message_passing_num": 2, "hidden_size": 16,
                       "node_input_size": 2, "output_size": 2, "edge_input_size": 3,
                       "num_mixture_components": 3, "temperature": 1.0}}
    model = get_model(param)
    assert (model.num_mixture_components, model.temperature, model.use_diagonal) == (3, 1.0, True)
    p = copy.deepcopy(param)
    p["model"].update({"type": "transformer", "num_heads": 4, "temperature": 0.0, "use_diagonal": False})
    model = get_model(p)
    assert isinstance(model.decode_module, GMMHead) and not isinstance(model.decode_module, DiagonalGMMHead)
    assert model.temperature == 0.0
    p["model"].pop("temperature")
    assert get_model(p).temperature is None
    p["model"]["precision"] = "bf16"
    model = get_model(p)
    head = model.decode_module
    assert model.dtype == torch.bfloat16 and head.pre_proj.compute_dtype == torch.bfloat16
    x = torch.randn(5, 16)
    assert head.pre_proj(x).dtype == torch.bfloat16
    out = head(x)
    assert out.dtype == torch.float32 and out.shape == (5, 3 * GMMHead.per_component(2))


def test_jax_gmm_weights_load_with_strict_names():
    """Twin of ``test_gmm_head_import``: a JAX EPD with a K = 3 head, its
    parameters exported in the reference layout, load into the port model
    with ``strict=True`` and give the same head output."""
    jax_sim, sim = _sim_pair("epd", K=3, temperature=1.0, use_diagonal=True, blocks=1, hidden=8)
    g = _graph("epd", seed=4)
    variables = jax_sim.init({"params": jax.random.key(0)}, _jax_graph(g))
    exported = export_reference_state_dict({"model": variables["params"]["model"]})
    state = {k[len("model."):]: torch.from_numpy(np.array(v, np.float32)) for k, v in exported.items()}
    assert {"decode_module.pre_proj.weight", "decode_module.proj.bias"} <= state.keys()
    sim.model.load_state_dict(state, strict=True)
    want = jax_sim.apply(variables, _jax_graph(g), is_training=True, mutable=["normalizer"])[0][0]
    got = sim(g.to("cpu"), is_training=True)[0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=EVAL_RTOL, atol=EVAL_ATOL)

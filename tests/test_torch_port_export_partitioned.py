"""The partitioned serving artifact (``utils.export.export_partitioned_eval_step``,
``grph-torch export --graph_partition``) against the JAX package (twin of
``tests/test_export.py::test_export_partitioned_roundtrip_matches_single_device``).

As the JAX test: the EPD of 2 blocks, width 16, on a 256-node symmetric
mesh in 4 halo parts, the normalizers after one training forward. The
parent exports one rank's program in-process (the trace exchanges
nothing), then one spawn of 4 gloo ranks (``parallel.mesh.launch``, one
intra-op thread a rank, a timeout) loads each artifact and runs it on its
part. Limits: the gathered rows within rtol 2e-4, atol 2e-5 of the JAX
single-device eval with the same weights and statistics (the JAX test's),
within 1e-6 of the live ``graph_parallel_forward`` and within 1e-4 of the
port's unpartitioned eval. Also: the gather mode, the transformer's
split-edge layout, a GMM head's draws per rank (equal to the live
partitioned eval's from the same per-rank generators), the refusal of a
group of another size, and ``grph-torch export --graph_partition 4`` on
the cylinder fixture, whose artifact the same ranks load and run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphphysics_tpu.core.graph import pad_graph_np as jax_pad_graph_np
from graphphysics_tpu.core.nodetype import NodeType
from graphphysics_tpu.models.processors import EncodeProcessDecode
from graphphysics_tpu.models.simulator import Simulator, SimulatorConfig
from graphphysics_tpu.utils.torch_import import export_reference_state_dict
from graphphysics_torch.cli import export as export_cli
from graphphysics_torch.core.graph import pad_graph_sorted_np
from graphphysics_torch.parallel.graph_partition import (
    part_of,
    partition_graph_halo_np,
    partition_graph_np,
)
from graphphysics_torch.parallel.mesh import launch
from graphphysics_torch.training import get_dataset, get_preprocessing
from graphphysics_torch.training.checkpoint import save_checkpoint
from graphphysics_torch.training.trainer import Trainer
from graphphysics_torch.utils.export import export_partitioned_eval_step

from tests import _torch_port_common  # noqa: F401  (thread cap, sync dispatch)
from tests._torch_port_common import cylinder_param, write_cylinder_split
from tests._torch_port_model_parallel_cases import build_sim, run_cases, stats_of
from tests._torch_port_partition_cases import raw_graph

LAUNCH_TIMEOUT_S = 180
PARTS = 4
JAX_TOL = dict(rtol=2e-4, atol=2e-5)
LIVE_ATOL = 1e-6
UNPARTITIONED_ATOL = 1e-4
CFG = dict(feature_index_start=0, feature_index_end=2, output_index_start=0,
           output_index_end=2, node_type_index=2)


def _stats(jax_norm) -> dict:
    out = {}
    for port, name in (("_node_normalizer", "node_normalizer"),
                       ("_edge_normalizer", "edge_normalizer"),
                       ("_output_normalizer", "output_normalizer")):
        st = jax_norm[name]["state"]
        for buf, field in (("_acc_count", "acc_count"), ("_num_accumulations", "num_accumulations"),
                           ("_acc_sum", "acc_sum"), ("_acc_sum_squared", "acc_sum_sq")):
            out[f"{port}.{buf}"] = np.array(getattr(st, field), np.float32)
    return out


@pytest.fixture(scope="module")
def jax_case():
    """The JAX test's simulator, its variables after one training forward,
    the raw mesh and the JAX single-device eval; the port spec with the
    same weights and statistics."""
    raw = raw_graph(n=256, seed=3)
    gj = jax.tree_util.tree_map(jnp.asarray, jax_pad_graph_np(**raw))
    cfg = SimulatorConfig(node_input_size=2 + NodeType.SIZE, edge_input_size=3, output_size=2,
                          **CFG)
    sim = Simulator(config=cfg, model=EncodeProcessDecode(
        message_passing_num=2, node_input_size=cfg.node_input_size, edge_input_size=3,
        output_size=2, hidden_size=16))
    variables = sim.init({"params": jax.random.key(0)}, gj)
    _, mutated = sim.apply(variables, gj, is_training=True, mutable=["normalizer"])
    variables = {"params": variables["params"], "normalizer": mutated["normalizer"]}
    _, _, want = sim.apply(variables, gj, is_training=False)
    state = {k[len("model."):]: np.array(v, np.float32)
             for k, v in export_reference_state_dict(variables["params"]).items()}
    spec = dict(family="epd", blocks=2, hidden=16, state=state, stats=_stats(mutated["normalizer"]))
    return raw, np.asarray(want), spec


def _export(spec, parts):
    return export_partitioned_eval_step(build_sim(spec).eval(), part_of(parts, 0).to("cpu"),
                                        parts.x.shape[0])


def _with_weights(spec, seed):
    """``spec`` with weights drawn from ``seed``, the same in every rank."""
    from graphphysics_torch.models.layers import reset_parameters

    model = reset_parameters(build_sim(spec).model, torch.Generator().manual_seed(seed))
    return dict(spec, state={k: v.detach().numpy().copy() for k, v in model.state_dict().items()})


def _unpartitioned(spec, graph, generator=None):
    sim = build_sim(spec).eval()
    with torch.no_grad():
        return sim(graph.to("cpu"), generator=generator)[2].numpy()


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """``grph-torch export --graph_partition 4`` on the cylinder fixture
    from a saved checkpoint: (the artifact, the parts, the spec, the
    unpartitioned eval)."""
    work = tmp_path_factory.mktemp("export_partitioned")
    h5, meta = write_cylinder_split(work)
    param = cylinder_param(h5, meta, "epd")
    cfg = work / "cfg.json"
    cfg.write_text(json.dumps(param))
    tr = Trainer(param, device="cpu", metrics_path=None, rollout_dir=None,
                 checkpoint_dir=str(work / "ck"), progress=False)
    tr.init_state(num_steps=1)
    ckpt = str(work / "state.pt")
    save_checkpoint(ckpt, tr)
    out = work / "exported"
    assert export_cli.main(["--training_parameters_path", str(cfg), "--model_path", ckpt,
                            "--output_dir", str(out), "--graph_partition", str(PARTS),
                            "--device", "cpu"]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["eval_step.pt2", f"eval_step_p{PARTS}.pt2"]
    ds = get_dataset(param, get_preprocessing(param, remove_noise=True), switch_to_val=True)
    example = ds[0]
    parts = export_cli.partition_example(tr.sim, example, PARTS)
    spec = dict(family="epd", blocks=2, hidden=16, stats=stats_of(tr.sim),
                state={k: v.numpy().copy() for k, v in tr.sim.model.state_dict().items()})
    with torch.no_grad():
        tr.sim.eval()
        want = tr.sim(example.to("cpu"))[2].numpy()
    return (out / f"eval_step_p{PARTS}.pt2").read_bytes(), parts, spec, want


@pytest.fixture(scope="module")
def ranks(jax_case, cli_case):
    raw, _, spec = jax_case
    g = pad_graph_sorted_np(**raw)
    halo, gather = partition_graph_halo_np(g, PARTS), partition_graph_np(g, PARTS)
    tf_raw = dict(raw, edge_attr=None)
    tf_spec = _with_weights(dict(family="transformer", blocks=2, hidden=16, heads=4), seed=1)
    tf = partition_graph_halo_np(pad_graph_sorted_np(**tf_raw), PARTS, split_local=True)
    gmm_spec = _with_weights(dict(family="epd", blocks=2, hidden=16, K=3, stats=spec["stats"]),
                             seed=2)
    blob, cli_parts, cli_spec, _ = cli_case
    cases = {
        "epd_halo": dict(spec=spec, parts=halo, blob=_export(spec, halo)),
        "epd_gather": dict(spec=spec, parts=gather, blob=_export(spec, gather)),
        "transformer_split": dict(spec=tf_spec, parts=tf, blob=_export(tf_spec, tf)),
        "gmm": dict(spec=gmm_spec, parts=halo, blob=_export(gmm_spec, halo)),
        "cli": dict(spec=cli_spec, parts=cli_parts, blob=blob),
        "other_group": dict(spec=spec, parts=halo,
                            blob=_export(spec, partition_graph_halo_np(g, 2))),
    }
    for case in cases.values():
        case["kind"] = "export"
    results = launch(run_cases, PARTS, "cpu", args=(cases,), timeout=LAUNCH_TIMEOUT_S, threads=1)
    return {name: [r[name] for r in results] for name in cases}, g


def test_export_partitioned_roundtrip_matches_single_device(jax_case, ranks):
    _, want, spec = jax_case
    results, g = ranks
    unpartitioned = _unpartitioned(spec, g)
    for mode in ("epd_halo", "epd_gather"):
        for res in results[mode]:
            assert res["num_parts"] == PARTS
            got = res["exported"]
            np.testing.assert_allclose(got, want, **JAX_TOL, err_msg=f"{mode} vs JAX")
            np.testing.assert_allclose(got, res["live"], rtol=0, atol=LIVE_ATOL)
            np.testing.assert_allclose(got, unpartitioned, rtol=0, atol=UNPARTITIONED_ATOL)
            np.testing.assert_array_equal(got, results[mode][0]["exported"])


def test_exported_partitioned_transformer_split_layout_matches_live(ranks):
    results, _ = ranks
    for res in results["transformer_split"]:
        np.testing.assert_allclose(res["exported"], res["live"], rtol=0, atol=LIVE_ATOL)


def test_exported_partitioned_gmm_draws_per_rank_as_the_live_eval(ranks):
    """Each rank draws its rows' sample from its own generator, in the
    artifact as in the live partitioned eval: the same numbers, and the
    ranks' draws differ."""
    results, _ = ranks
    for res in results["gmm"]:
        np.testing.assert_allclose(res["exported"], res["live"], rtol=0, atol=LIVE_ATOL)
    rows = results["gmm"][0]["exported"].shape[0] // PARTS
    a, b = results["gmm"][0]["exported"][:rows], results["gmm"][0]["exported"][rows:2 * rows]
    assert not np.allclose(a - a.mean(), b - b.mean())


def test_partitioned_artifact_refuses_a_group_of_another_size(ranks):
    results, _ = ranks
    for res in results["other_group"]:
        assert "serves a group of 2 ranks" in res["refused"] and "has 4" in res["refused"]


def test_export_cli_graph_partition_writes_and_reloads(cli_case, ranks):
    _, parts, _, want = cli_case
    results, _ = ranks
    nl = parts.x.shape[1]
    for res in results["cli"]:
        got = res["exported"][:want.shape[0]]
        assert res["exported"].shape[0] == PARTS * nl
        np.testing.assert_allclose(got, want, rtol=0, atol=UNPARTITIONED_ATOL)
        np.testing.assert_allclose(res["exported"], res["live"], rtol=0, atol=LIVE_ATOL)


def test_exported_partitioned_program_traces_the_exchanges():
    """The artifact's graph holds one traced exchange per layer (halo mode:
    ``all_to_all_rows``; gather mode: ``all_gather_rows``) and the kernel
    op of the segment sum, and no process group."""
    import io

    raw = raw_graph(n=64, seed=1)
    spec = dict(family="epd", blocks=2, hidden=8)
    g = pad_graph_sorted_np(**raw)
    for parts, op in ((partition_graph_halo_np(g, 2), "all_to_all_rows"),
                      (partition_graph_np(g, 2), "all_gather_rows")):
        program = torch.export.load(io.BytesIO(_export(spec, parts)))
        code = program.graph_module.code
        assert code.count(f"graphphysics_torch.{op}") == 2
        assert "graphphysics_torch.csr_segment_sum" in code

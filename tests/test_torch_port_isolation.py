"""The port stands alone: ``graphphysics_torch``, ``chip_smoke.py``,
``chip_smoke_mutants.py``, ``chip_compare.py``, ``chip_fidelity.py``,
``chip_partition.py``, ``chip_utilities.py``, the
loader-worker cases that spawned workers import
(``tests/_torch_port_loader_cases.py``) and the partition cases that
spawned graph ranks import (``tests/_torch_port_partition_cases.py``; the
partition modules ``graphphysics_torch/parallel/*`` and ``ops/halo.py``
among the package's) import no JAX, flax, optax or
``graphphysics_tpu``, build no kernel and start no thread or process on
import, and their entry points run on CUDA by default, raising where there
is none."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import _torch_port_common  # noqa: F401  (caps torch's threads)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "graphphysics_tpu")


def _port_sources():
    scripts = [ROOT / "chip_smoke.py", ROOT / "chip_smoke_mutants.py", ROOT / "chip_compare.py",
               ROOT / "chip_partition.py", ROOT / "chip_utilities.py",
               ROOT / "chip_fidelity.py", ROOT / "tests" / "_torch_port_loader_cases.py",
               ROOT / "tests" / "_torch_port_partition_cases.py"]
    return sorted((ROOT / "graphphysics_torch").rglob("*.py")) + scripts


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = (
        "import sys, json\n"
        "before = set(sys.modules)\n"
        "import graphphysics_torch.core, graphphysics_torch.ops, graphphysics_torch.models\n"
        "import graphphysics_torch.dataset, graphphysics_torch.training\n"
        "import graphphysics_torch.topology, graphphysics_torch.utils.synthetic\n"
        "import graphphysics_torch.utils.reference_weights\n"
        "import graphphysics_torch.ops.attention, graphphysics_torch.ops.csr_attention\n"
        "import graphphysics_torch.training.parse_parameters\n"
        "import graphphysics_torch.training.trainer, graphphysics_torch.training.losses\n"
        "import graphphysics_torch.training.schedule, graphphysics_torch.dataset.loader\n"
        "import graphphysics_torch.dataset.dataset, graphphysics_torch.dataset.h5_dataset\n"
        "import graphphysics_torch.training.checkpoint, graphphysics_torch.utils\n"
        "import graphphysics_torch.utils.xdmf, graphphysics_torch.utils.metrics\n"
        "import graphphysics_torch.cli.train, graphphysics_torch.cli.predict\n"
        "import graphphysics_torch.cli.__main__, graphphysics_torch.external\n"
        "import graphphysics_torch.dataset.xdmf_dataset, chip_fidelity\n"
        "import graphphysics_torch.topology.build, graphphysics_torch.dataset.preprocessing\n"
        "import graphphysics_torch.utils.synthetic, tests._torch_port_loader_cases\n"
        "import graphphysics_torch.parallel, graphphysics_torch.parallel.mesh\n"
        "import graphphysics_torch.parallel.dp, graphphysics_torch.parallel.graph_partition\n"
        "import graphphysics_torch.parallel.reorder, graphphysics_torch.ops.halo\n"
        "import tests._torch_port_partition_cases, chip_partition\n"
        "import graphphysics_torch.utils.export, graphphysics_torch.utils.determinism\n"
        "import graphphysics_torch.utils.profiling, graphphysics_torch.utils.compilation_cache\n"
        "import graphphysics_torch.utils.meshmask, graphphysics_torch.utils.mesh_export\n"
        "import graphphysics_torch.utils.visualization, graphphysics_torch.cli.export\n"
        "import graphphysics_torch.cli.doctor, chip_utilities\n"
        "import threading, multiprocessing\n"
        "from graphphysics_torch.ops import _native\n"
        "print(json.dumps({'new': sorted(set(sys.modules) - before),\n"
        "                  'loaded': sorted(_native._loaded),\n"
        "                  'threads': threading.active_count(),\n"
        "                  'children': len(multiprocessing.active_children())}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in result["new"]
              if m.split(".")[0] in FORBIDDEN or m in ("h5py", "matplotlib")]
    assert leaked == []
    assert result["loaded"] == []
    assert result["threads"] == 1 and result["children"] == 0


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from graphphysics_torch.core import pad_graph_sorted_np
    from graphphysics_torch.models import EncodeProcessDecode, Simulator, SimulatorConfig
    from graphphysics_torch.ops import csr_segment_sum
    from graphphysics_torch.training import rollout

    cfg = SimulatorConfig(11, 3, 2, 0, 2, 0, 2, 2)
    model = EncodeProcessDecode(1, 11, 3, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulator(cfg, model)
    r = np.random.default_rng(0)
    g = pad_graph_sorted_np(
        np.zeros((10, 4), np.float32), np.zeros((10, 2), np.float32),
        r.integers(0, 10, 20).astype(np.int32), r.integers(0, 10, 20).astype(np.int32),
        16, 32, edge_attr=np.zeros((20, 3), np.float32), y=np.zeros((10, 2), np.float32),
        node_type_index=2,
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g.to()
    sim = Simulator(cfg, model, device="cpu")
    from graphphysics_torch.core import stack_graphs

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rollout(sim, stack_graphs([g]))
    from graphphysics_torch.training import Trainer

    param = {"model": {"type": "epd", "message_passing_num": 1, "hidden_size": 8,
                       "node_input_size": 2, "output_size": 2, "edge_input_size": 3},
             "index": {"feature_index_start": 0, "feature_index_end": 2,
                       "output_index_start": 0, "output_index_end": 2, "node_type_index": 2}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(param)
    # the CPU path works when asked for, and never touches the kernel
    before = csr_segment_sum.launches
    preds, _ = rollout(sim, stack_graphs([g]), device="cpu")
    assert preds.shape == (1, 16, 2) and csr_segment_sum.launches == before


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=120
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_chip_fidelity_refuses_without_cuda(tmp_path):
    """The fidelity runner's default device is the card: without one it
    exits non-zero with no result and writes no data."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_fidelity.py"), "--epochs", "1", "--workdir",
         str(tmp_path / "work")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "val_all_rollout_rmse" not in out.stdout
    assert not (tmp_path / "work").exists()

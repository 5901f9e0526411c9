"""The port stands alone: ``graphphysics_torch`` and ``chip_smoke.py`` import
no JAX, flax, optax or ``graphphysics_tpu``, build no kernel on import, and
their entry points run on CUDA by default, raising where there is none."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "graphphysics_tpu")


def _port_sources():
    return sorted((ROOT / "graphphysics_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        "from graphphysics_torch.ops import _native\n"
        "print(json.dumps({'new': sorted(set(sys.modules) - before),\n"
        "                  'loaded': sorted(_native._loaded)}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    leaked = [m for m in result["new"] if m.split(".")[0] in FORBIDDEN or m == "h5py"]
    assert leaked == []
    assert result["loaded"] == []


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

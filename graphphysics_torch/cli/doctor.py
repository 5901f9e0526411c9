"""Health checks: ``grph-torch doctor`` (counterpart of
``graphphysics_tpu/cli/doctor.py``).

    grph-torch doctor [--device cuda] [--skip-probes] [--skip-determinism]

It reports the device (on a card its name and power limit, as
``nvidia-smi`` reads them, since a card set below its maximum power runs
slower), which of the kernels' libraries are built and where (the build
directory, as the JAX doctor reports its compilation cache), the device's
matrix-product rate in float32 (TF32 off) and bfloat16 and its memory copy
rate right now, whether a noisy dataset item replays bit for bit, and
whether a train step of the EncodeProcessDecode and of the transformer
(float32 and bfloat16) replays bit for bit from cloned state. On a card
the float32 steps are expected not to: the EncodeProcessDecode's gathers
take their gradient by ``index_add_`` and the fused attention's float32
backward sums dk and dv, both with atomics; the check then counts the
leaves that differ and passes with that note. The bf16 transformer's
backward has no atomics: any difference there, or on the CPU, fails.

Exit code 0 when every check passed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="graphphysics_torch health checks")
    p.add_argument("--device", default="cuda", help="torch device (cuda unless named)")
    p.add_argument("--skip-probes", action="store_true",
                   help="skip the matrix-product and memory probes")
    p.add_argument("--skip-determinism", action="store_true",
                   help="skip the item and step replay checks")
    return p


def _check(name: str, fn, results: list) -> None:
    try:
        detail = fn()
        results.append(True)
        print(f"  ok    {name}" + (f" - {detail}" if detail else ""), flush=True)
    except Exception as e:  # noqa: BLE001 - a doctor reports, it does not crash
        results.append(False)
        print(f"  FAIL  {name} - {type(e).__name__}: {e}", flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _param(kind: str, precision: str = "f32") -> dict:
    """A small training config of each family (2 blocks, 32 wide), the
    cylinder's fields for the EncodeProcessDecode, the panels' for the
    transformer."""
    model = {"type": "epd", "message_passing_num": 2, "hidden_size": 32, "node_input_size": 2,
             "output_size": 2, "edge_input_size": 3}
    index = {"feature_index_start": 0, "feature_index_end": 2, "output_index_start": 0,
             "output_index_end": 2, "node_type_index": 2}
    if kind == "transformer":
        model.update(type="transformer", output_size=3, edge_input_size=0, num_heads=4)
        index.update(output_index_end=3, node_type_index=3)
    if precision == "bf16":
        model["precision"] = "bf16"
    noise = {"noise": 0.02, "noise_index_start": [0], "noise_index_end": [2], "masking": 0}
    return {"model": model, "index": index,
            "transformations": {"preprocessing": noise, "world_pos_parameters": {"use": False}}}


def _dataset(kind: str, directory: str, val: bool = False):
    """A noisy in-memory dataset of one synthetic trajectory in the
    family's edge layout (no files but its meta)."""
    from graphphysics_torch.dataset import MemoryDataset
    from graphphysics_torch.training import edge_layout, get_preprocessing
    from graphphysics_torch.utils import synthetic

    param = _param(kind)
    make = synthetic.cylinder_trajectory if kind == "epd" else synthetic.panels_trajectory
    traj, meta = make(steps=4, nx=16, ny=8)
    meta_path = synthetic.write_json(f"{directory}/{kind}_meta.json", meta)
    edges = param["model"]["edge_input_size"] > 0
    return MemoryDataset([traj], meta_path,
                         preprocessing=get_preprocessing(param, use_edge_feature=edges, remove_noise=val),
                         add_edge_features=edges, edge_layout=edge_layout(param),
                         node_type_index=param["index"]["node_type_index"], seed=0)


def step_report(kind: str, precision: str, device, directory: str) -> dict:
    """``check_step_determinism`` of one Trainer step of the family on a
    dataset item, from cloned state (two runs)."""
    from graphphysics_torch.training import Trainer
    from graphphysics_torch.utils.determinism import (
        check_step_determinism,
        trainer_state,
        trainer_step,
    )

    trainer = Trainer(_param(kind, precision), metrics_path=None, rollout_dir=None, device=device)
    trainer.init_state(num_steps=10)
    batch = _dataset(kind, directory)[1].to(trainer.device)
    trainer.train_step(batch)  # optimizer slots exist from here on
    return check_step_determinism(trainer_step(trainer), trainer_state(trainer), batch, runs=2)


# why the steps known not to replay bit for bit on a card do not
ATOMICS = {"epd": "the gathers' index_add_ gradients", "transformer": "the fused backward's dk/dv"}


def expected_to_differ(kind: str, precision: str, device) -> bool:
    """The steps known not to replay bit for bit: the float32 ones on a
    card (``ATOMICS``)."""
    import torch

    return precision == "f32" and torch.device(device).type == "cuda"


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    import torch

    from graphphysics_torch.core.device import resolve_device
    from graphphysics_torch.ops import _native

    results: list = []
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def devices():
        line = f"torch {torch.__version__}, device {device}"
        if device.type == "cuda":
            line += (f": {torch.cuda.device_count()}x {torch.cuda.get_device_name(device)}, "
                     f"nvidia-smi: {nvidia_smi()}")
        return line

    _check("device", devices, results)

    def libraries():
        built = {s: _native.library_path(s).exists() for s in _native.SOURCES}
        names = ", ".join(f"{s} {'built' if ok else 'not built'}" for s, ok in built.items())
        return f"build directory {_native.BUILD_DIR}: {names}"

    _check("kernel libraries", libraries, results)

    if not args.skip_probes:
        def probes():
            from graphphysics_torch.utils.profiling import chip_probe_gbps, chip_probe_tflops

            f32 = chip_probe_tflops(dtype=torch.float32, device=device)
            bf16 = chip_probe_tflops(dtype=torch.bfloat16, device=device)
            gbps = chip_probe_gbps(device=device)
            return (f"{json.dumps({'device': str(device), 'f32_tflops': f32, 'bf16_tflops': bf16, 'copy_gbps': gbps})}"
                    f" (right now; compare measurements only against probes of the same run)")

        _check("throughput probes", probes, results)

    if not args.skip_determinism:
        tmp = tempfile.TemporaryDirectory(prefix="grph_torch_doctor_")

        def item_determinism():
            from graphphysics_torch.utils.determinism import check_item_determinism

            ds = _dataset("epd", tmp.name)
            report = check_item_determinism(ds, 1)
            if not report["deterministic"]:
                raise AssertionError(f"item replay mismatches: {report['mismatches']}")
            ds.set_epoch(1)
            other = ds[1]
            ds.set_epoch(0)
            if np.array_equal(np.asarray(ds[1].x), np.asarray(other.x)):
                raise AssertionError("the noise did not change between epochs: nothing was checked")
            return "a noisy dataset item replays bit for bit"

        _check("input-pipeline determinism", item_determinism, results)

        for kind, precision in (("epd", "f32"), ("transformer", "f32"), ("transformer", "bf16")):
            def step(kind=kind, precision=precision):
                report = step_report(kind, precision, device, tmp.name)
                if report["deterministic"]:
                    return f"replays bit for bit ({report['compared']} leaves)"
                differ = (f"{len(report['mismatches'])} of {report['compared']} leaves differ, "
                          f"largest {max(report['max_abs_diff'].values(), default=0.0):.3g}")
                if expected_to_differ(kind, precision, device):
                    return f"{differ} (expected on a card: {ATOMICS[kind]} atomics)"
                raise AssertionError(f"{differ}: {report['mismatches'][:8]}")

            _check(f"train-step determinism, {kind} {precision}", step, results)
        tmp.cleanup()

    ok = all(results)
    print(("all checks passed" if ok else "CHECKS FAILED") + f" ({sum(results)}/{len(results)})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""How far a planted fault moves two checks of ``chip_smoke.py``: a fault in
K1b or in the fused attention backward moves ``first_step``, the check of the first train step on the
card against the CPU (the readings its per-model gradient limits
``EPD_GRAD_RTOL``, ``TRANSFORMER_GRAD_RTOL`` must sit below); a fault in
the checkpoint restore moves ``resume_runs``, the check of a resumed run
against an uninterrupted one (the readings ``RESUME_MEDIAN_RTOL`` and the
per-model worst limits must sit below).

For each fault the tree is copied to a temporary directory, one line of a
source is replaced there, the kernels are built from the copy and the check
runs with its limits lifted: ``first_step`` on the flagship batch (K1b
faults, EPD 15 x 128) or the panels batch (faults in
``csrc/csr_attention_bwd.cu``, transformer 15 x 128); ``resume_runs`` on the in-memory trajectories of the checkpoint
phases. One JSON line per fault. The repo itself is never changed. Needs
one CUDA card:

    python3 chip_smoke_mutants.py [name prefix]

A name prefix (``k1b``, ``attn``, ``resume``) runs those faults only. K2's
and K3's faults are caught by their kernel phases against their plain
versions: no path of the models runs them.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
K1 = "graphphysics_torch/csrc/csr_segment_sum.cu"
ATTN = "graphphysics_torch/csrc/csr_attention_bwd.cu"
K1B_LIVE = "if (live) live = bounds[r] <= e && e < bounds[num_rows + r];"
ATTN_DS = "ds[p] = attn[p] * (vg[p] - delta[p]);"
ATTN_DK = "add_cols<V>(dk + static_cast<int64_t>(j) * width + r.col0, dkr);"
ATTN_DQ = "for (int i = 0; i < V; ++i) dqa[i] += ds[i % NP] * scale * kc[i];"
CKPT = "graphphysics_torch/training/checkpoint.py"
OPT_LOAD = '    trainer.optimizer.load_state_dict(ckpt["optimizer"])'
WEIGHTS_LOAD = "    load_reference_checkpoint(sim, ckpt)"
ZERO_NORMALIZERS = (WEIGHTS_LOAD + "\n    for n, b in sim.named_buffers():\n"
                    "        if \"_normalizer.\" in n:\n            b.zero_()")
# name -> (model, source, line, faulty line); graph 5 of the panels batch is
# the one with empty softmax rows
FAULTS = {
    "k1b_zero_graph5": ("epd", K1, K1B_LIVE, K1B_LIVE[:-1] + " && r / 2048 != 5;"),
    "k1b_drop_last_edge": ("epd", K1, K1B_LIVE, K1B_LIVE.replace("e < bounds", "e + 1 < bounds")),
    "attn_ds_x1.001": ("transformer", ATTN, ATTN_DS, ATTN_DS.replace("= attn", "= 1.001f * attn")),
    "attn_ds_x1.01": ("transformer", ATTN, ATTN_DS, ATTN_DS.replace("= attn", "= 1.01f * attn")),
    # graph 5's senders add nothing to dk
    "attn_dk_zero_graph5": ("transformer", ATTN, ATTN_DK, "if (r.row / 2048 != 5) " + ATTN_DK),
    # each row's last edge adds nothing to dq
    "attn_dq_drop_last_edge": ("transformer", ATTN, ATTN_DQ, ATTN_DQ.replace(
        "+= ds[i % NP] * scale * kc[i];", "+= first + t + 1 < r.len ? ds[i % NP] * scale * kc[i] : 0.0f;")),
    # the resumed run starts with fresh AdamW moments and step counts
    "resume_fresh_optimizer_epd": ("epd", CKPT, OPT_LOAD, "    pass"),
    "resume_fresh_optimizer_transformer": ("transformer", CKPT, OPT_LOAD, "    pass"),
    # the resumed run starts with zero normalizer statistics
    "resume_zero_normalizers_epd": ("epd", CKPT, WEIGHTS_LOAD, ZERO_NORMALIZERS),
    "resume_zero_normalizers_transformer": ("transformer", CKPT, WEIGHTS_LOAD, ZERO_NORMALIZERS),
}


def read_resume_fault(model: str, name: str) -> dict:
    """``resume_runs`` with lifted limits."""
    import chip_smoke as cs
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    cs.RESUME_MEDIAN_RTOL = cs.ADAM_STEP_MAX = math.inf
    if model == "epd":
        param, make_traj = cs.load_config(cs.CYLINDER_CONFIG), cylinder_trajectory
    else:
        param, make_traj = cs.load_config(cs.PANELS_CONFIG), panels_trajectory
    with tempfile.TemporaryDirectory() as tmp:
        train_ds, val_ds = cs.memory_datasets(param, make_traj, 0, tmp, cs.CKPT_TRAJECTORIES)
        readings = cs.resume_runs(name, param, train_ds, val_ds, {}, {}, 0, tmp, math.inf)[0]
    keep = ("resume_param_rel_err_worst", "resume_worst_param", "resume_param_rel_err_median",
            "resume_roundoff_leaf_max_abs_diff", "rerun_param_rel_err_worst",
            "rerun_param_rel_err_median", "rerun_roundoff_leaf_max_abs_diff")
    return {"fault": name, **{k: readings[k] for k in keep}}


def read_fault(model: str, name: str) -> dict:
    """The fault's check with lifted limits, in the tree of the working
    directory."""
    import torch

    import chip_smoke as cs
    from graphphysics_torch.ops import _native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _native.build()
    if name.startswith("resume"):
        return read_resume_fault(model, name)
    cs.STEP_LOSS_RTOL = cs.STEP_ROUNDOFF_SHARE = math.inf
    if model == "epd":
        param, batch = cs.load_config(cs.CYLINDER_CONFIG), cs.flagship_batch(0)
    else:
        param, batch = cs.load_config(cs.PANELS_CONFIG), cs.panels_batch(200)
    total_steps = 1 + cs.WARMUP_STEPS + cs.TIMED_STEPS + cs.PROFILED_STEPS
    return {"fault": name, **cs.first_step(name, param, batch, 0, total_steps, math.inf)}


def main() -> int:
    if len(sys.argv) == 3:  # the child: one fault, in its copy
        print("RESULT " + json.dumps(read_fault(*sys.argv[1:])), flush=True)
        return 0
    prefix = sys.argv[1] if len(sys.argv) == 2 else ""
    failed = 0
    for name, (model, source, line, faulty) in FAULTS.items():
        if not name.startswith(prefix):
            continue
        with tempfile.TemporaryDirectory() as tmp:
            copy = os.path.join(tmp, "tree")
            shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(".git", "build", "chiprun_out"))
            path = os.path.join(copy, source)
            with open(path) as fp:
                text = fp.read()
            if text.count(line) != 1:
                raise SystemExit(f"{name}: the line to replace is not in {source} once")
            with open(path, "w") as fp:
                fp.write(text.replace(line, faulty))
            script = os.path.join(copy, os.path.basename(__file__))
            proc = subprocess.run([sys.executable, script, model, name], cwd=copy,
                                  capture_output=True, text=True, timeout=600)
        lines = [x[len("RESULT "):] for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
        if proc.returncode or not lines:
            failed += 1
            print(f"{name}: failed\n{proc.stderr[-3000:]}", file=sys.stderr, flush=True)
        else:
            print(lines[-1], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

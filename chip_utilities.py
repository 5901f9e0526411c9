"""The phases of ``chip_smoke.py`` for the serving artifacts, the directory
checkpoints and the utilities (run from it, on one card):

- ``export_serving``: the 15 x 128 EncodeProcessDecode on the flagship
  frame (2,048 nodes) and the 15 x 128 panels transformer on the panels
  frame, in float32, and that transformer in bf16: the eval step exported
  with ``torch.export`` (``utils/export.py``), saved, loaded back and run
  on CUDA tensors over the trajectory's frames, every launch count zeroed
  just before and read just after (15 K1, 15 fused f32 or 15 fused bf16
  launches a frame), its outputs against the live eval step's (relative
  to their largest magnitude), its ms per frame beside the eager
  forward's; and a 10-frame ``export_rollout`` of the EPD against the live
  ``rollout`` (its export and save, and its load, timed apart);
- ``checkpoint_backends``: the cylinder 15 x 128 trainer's state after two
  steps on the 8 x 2,048 batch saved with ``"orbax"`` and
  ``"orbax-async"`` (``torch.distributed.checkpoint`` directories),
  reloaded into a fresh trainer bit for bit, and one step resumed from it
  against the uninterrupted run's next step under ``chip_smoke``'s resume
  limits; the save and load seconds and the bytes;
- ``profiler``: 3 ``Trainer.fit`` steps of each family with ``profile_dir``
  set, on one noisy 2,048-node trajectory of each; the Chrome trace must
  name K1 and K1b (EPD) and the fused pair (transformer), 15 launches a
  step each;
- ``determinism``: ``check_item_determinism`` on the profiler's noisy
  cylinder dataset, ``check_step_determinism`` on the batches of the EPD
  f32 step (the checkpoint phase's trainer), the transformer f32 step (the
  profiler's) and the bf16 one: only the bf16 transformer has to replay
  bit for bit (its backward has no atomics); the f32 steps report the
  leaves that differ;
- ``compilation_cache``: ``enable_compilation_cache`` (what
  ``--compilation_cache_dir`` calls) on a fresh directory, one source
  built there and then reused, with both seconds;
- ``doctor``: ``grph-torch doctor`` through the CLI's entry point in this
  process returns 0, its lines (its probes among them) in the phase's line.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

import torch

EXPORT_RTOL = 1e-6  # the artifact's output against the live step's
ROLLOUT_TOL = 1e-4  # the exported rollout against the live one
EXPORT_ROLLOUT_FRAMES = 10
PROFILED_FIT_STEPS = 3
CACHE_SOURCE = "csr_segment_sum.cu"


def _cs():
    import chip_smoke

    return chip_smoke


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference over the largest magnitude."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def export_serving(name, sim, frames, counts, expected, rollout_frames=0) -> dict:
    """``sim``'s eval step exported, saved, loaded and run on every frame of
    ``frames`` (on the card), launches checked against ``expected`` (kernel
    -> launches a frame), outputs against the live step; with
    ``rollout_frames``, the exported rollout of that many frames against the
    live one."""
    from graphphysics_torch.training import rollout
    from graphphysics_torch.utils.export import (
        export_rollout,
        load_eval_step_file,
        load_rollout,
        save_eval_step,
    )

    cs = _cs()
    frames_dev = frames.to("cuda")
    n_frames = frames_dev.x.shape[0]
    for t in range(n_frames):
        sim.accumulate_stats(frames_dev[t])
    sim.eval()
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/eval_step.pt2"
        t0 = time.perf_counter()
        save_eval_step(path, sim, frames_dev[0])
        export_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        step = load_eval_step_file(path)
        load_s = time.perf_counter() - t0
    step(frames_dev[0])  # warm-up
    torch.cuda.synchronize()
    for fn in counts.values():
        fn.launches = 0
    outs = [step(frames_dev[t]) for t in range(n_frames)]
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counts.items()}
    want = {k: expected.get(k, 0) * n_frames for k in counts}
    if launches != want:
        raise AssertionError(f"{name}: exported step launches {launches}, expected {want}")
    with torch.inference_mode():
        live = [sim(frames_dev[t])[2] for t in range(n_frames)]
    rel = max(_rel_err(a, b) for a, b in zip(outs, live))
    if not rel <= EXPORT_RTOL:
        raise AssertionError(f"{name}: exported step vs live, relative error {rel} > {EXPORT_RTOL}")
    exported_ms = cs.call_ms(lambda: step(frames_dev[0]))
    with torch.inference_mode():
        eager_ms = cs.call_ms(lambda: sim(frames_dev[0]))
    result = {
        "frames": n_frames, "export_s": export_s, "load_s": load_s, "artifact_bytes": size,
        "launches": launches, "max_rel_err": rel, "rtol": EXPORT_RTOL,
        "exported_ms_per_frame": exported_ms, "eager_ms_per_frame": eager_ms,
    }
    if rollout_frames:
        part = frames_dev[:rollout_frames]
        t0 = time.perf_counter()
        blob = export_rollout(sim, part)
        t1 = time.perf_counter()
        run = load_rollout(blob)
        result.update(rollout_export_s=t1 - t0, rollout_load_s=time.perf_counter() - t1,
                      rollout_artifact_bytes=len(blob))
        for fn in counts.values():
            fn.launches = 0
        preds, targets = run(part)
        torch.cuda.synchronize()
        roll_launches = {k: fn.launches for k, fn in counts.items()}
        want = {k: expected.get(k, 0) * rollout_frames for k in counts}
        if roll_launches != want:
            raise AssertionError(f"{name}: exported rollout launches {roll_launches}, expected {want}")
        live_preds, live_targets = rollout(sim, part, device="cuda")
        err = (preds - live_preds).abs().max().item()
        if not torch.allclose(preds, live_preds, rtol=ROLLOUT_TOL, atol=ROLLOUT_TOL) or not torch.equal(
                targets, live_targets):
            raise AssertionError(f"{name}: exported rollout vs live, max_abs_err {err}")
        result.update(rollout_frames=rollout_frames, rollout_max_abs_err=err,
                      rollout_tolerance=ROLLOUT_TOL, rollout_launches=roll_launches)
        result["launches"] = {k: launches[k] + roll_launches[k] for k in counts}
    return result


def _directory_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path) for f in files)


def _params(trainer) -> dict:
    return {k: p.detach().clone() for k, p in trainer.sim.named_parameters()}


def trainer(param, seed):
    """A cylinder or panels Trainer on the card with fresh state."""
    from graphphysics_torch.training import Trainer

    tr = Trainer(param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda", metrics_path=None,
                 rollout_dir=None)
    tr.init_state(10)
    return tr


def checkpoint_backends(run, param, dev_batch, seed) -> dict:
    """The state of ``run`` (a trainer that has stepped on ``dev_batch``)
    saved with each directory backend, reloaded bit for bit into a fresh
    trainer, one step resumed from it against the uninterrupted run's."""
    from graphphysics_torch.training.checkpoint import (
        load_checkpoint_with_metadata,
        save_checkpoint,
        wait_for_async_saves,
    )

    cs = _cs()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("orbax", "orbax-async"):
            path = f"{tmp}/{backend}/state.orbax"
            start = _params(run)
            saved = {k: v.detach().clone() for k, v in run.sim.state_dict().items()}
            t0 = time.perf_counter()
            save_checkpoint(path, run, metadata={"epoch": 0, "step": run.step}, backend=backend)
            call_s = time.perf_counter() - t0
            wait_for_async_saves()
            save_s = time.perf_counter() - t0
            fresh = trainer(param, seed + 1)
            t0 = time.perf_counter()
            _, meta = load_checkpoint_with_metadata(path, fresh)
            load_s = time.perf_counter() - t0
            state = fresh.sim.state_dict()
            differ = [k for k, v in saved.items() if not torch.equal(state[k], v)]
            mine, theirs = fresh.optimizer.state_dict()["state"], run.optimizer.state_dict()["state"]
            differ += [f"optimizer.{i}.{n}" for i, slots in theirs.items() for n, v in slots.items()
                       if not torch.equal(mine[i][n].to(v.device), v)]
            if differ or fresh.step != run.step or meta["step"] != run.step:
                raise AssertionError(f"checkpoint_backends:{backend}: reload differs in {differ[:8]} "
                                     f"(step {fresh.step} vs {run.step})")
            run.train_step(dev_batch)
            fresh.train_step(dev_batch)
            rel, _ = cs.update_rel_errs(_params(fresh), _params(run), start)
            values = sorted(rel.values())
            median, worst = values[len(values) // 2], values[-1]
            if median > cs.RESUME_MEDIAN_RTOL or worst > cs.EPD_RESUME_WORST_RTOL:
                raise AssertionError(f"checkpoint_backends:{backend}: resumed step median {median}, "
                                     f"worst {worst}")
            out[backend] = {"save_call_s": call_s, "save_s": save_s, "load_s": load_s,
                            "bytes": _directory_bytes(path), "reload_bitwise": True,
                            "resumed_step_median_rel": median, "resumed_step_worst_rel": worst,
                            "median_rtol": cs.RESUME_MEDIAN_RTOL, "worst_rtol": cs.EPD_RESUME_WORST_RTOL}
    return out


def determinism(item_ds, steps) -> dict:
    """The item check on the noisy cylinder dataset ``item_ds`` and the step
    check of each ``(label, trainer, batch on the card, must replay)`` of
    ``steps`` (trainers that have stepped, so their optimizer slots exist);
    only the bf16 transformer must replay bit for bit."""
    from graphphysics_torch.utils.determinism import (
        check_item_determinism,
        check_step_determinism,
        trainer_state,
        trainer_step,
    )

    item = check_item_determinism(item_ds, 1)
    if not item["deterministic"]:
        raise AssertionError(f"determinism: a dataset item differs when rebuilt: {item['mismatches']}")
    out = {"item": item}
    for label, tr, dev_batch, must in steps:
        report = check_step_determinism(trainer_step(tr), trainer_state(tr), dev_batch, runs=2)
        if must and not report["deterministic"]:
            raise AssertionError(f"determinism:{label}: the step does not replay bit for bit: "
                                 f"{report['mismatches'][:8]}")
        out[label] = {
            "deterministic": report["deterministic"], "must_replay": must,
            "leaves_compared": report["compared"], "leaves_differing": len(report["mismatches"]),
            "largest_abs_diff": max(report["max_abs_diff"].values(), default=0.0),
            "differing": report["mismatches"][:12],
        }
    return out


def profiler(families, seed, directory) -> tuple:
    """``PROFILED_FIT_STEPS`` steps of ``Trainer.fit`` for each ``label ->
    (param, training dataset)`` of ``families`` with ``profile_dir`` set
    under ``directory``; the kernels the trace names, counted. Returns the
    phase's result and the trainers, by label."""
    from graphphysics_torch.dataset import GraphLoader
    from graphphysics_torch.training import Trainer

    kernels = {"epd": ("csr_segment_sum_kernel", "csr_segment_sum_bwd_kernel"),
               "transformer": ("csr_attention_kernel", "csr_attention_bwd_kernel")}
    out, trainers = {}, {}
    for label, (param, train_ds) in families.items():
        blocks = param["model"]["message_passing_num"]
        loader = GraphLoader(train_ds, batch_size=2, shuffle=False, prefetch=0)
        tr = trainers[label] = Trainer(
            param, learning_rate=1e-4, warmup=2, seed=seed, device="cuda", metrics_path=None,
            rollout_dir=None, checkpoint_dir=f"{directory}/{label}_ckpt",
            profile_dir=f"{directory}/{label}_prof", profile_start_step=1,
            profile_num_steps=PROFILED_FIT_STEPS)
        t0 = time.perf_counter()
        tr.fit(loader, num_epochs=1)
        fit_s = time.perf_counter() - t0
        path = f"{directory}/{label}_prof/trace.json"
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        device = [e for e in events if e.get("cat") == "kernel"]
        found = {k: sum(k in e["name"] for e in device) for k in kernels[label]}
        want = {k: blocks * PROFILED_FIT_STEPS for k in kernels[label]}
        if found != want:
            raise AssertionError(f"profiler:{label}: the trace names {found}, expected {want}")
        mine = sum(e.get("dur", 0) for e in device if any(k in e["name"] for k in kernels[label]))
        total = sum(e.get("dur", 0) for e in device)
        out[label] = {"steps_traced": PROFILED_FIT_STEPS, "fit_steps": len(loader), "fit_s": fit_s,
                      "trace_bytes": os.path.getsize(path), "kernel_events": len(device),
                      "named": found, "device_ms_traced": total / 1e3,
                      "hand_written_share": mine / max(total, 1)}
    return out, trainers


def compilation_cache(directory) -> dict:
    """One source built into a fresh cache directory, then reused."""
    from graphphysics_torch.ops import _native
    from graphphysics_torch.utils.compilation_cache import enable_compilation_cache

    before = _native.BUILD_DIR
    try:
        enable_compilation_cache(directory)
        t0 = time.perf_counter()
        first = _native.build([CACHE_SOURCE])[CACHE_SOURCE]
        first_wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = _native.build([CACHE_SOURCE])[CACHE_SOURCE]
        reuse_wall = time.perf_counter() - t0
        built = sorted(os.listdir(directory))
    finally:
        _native.set_build_dir(before)
    if again != 0.0 or built != [_native.library_path(CACHE_SOURCE).name]:
        raise AssertionError(f"compilation_cache: not reused ({again} s), directory holds {built}")
    return {"source": CACHE_SOURCE, "first_build_s": first, "first_build_wall_s": first_wall,
            "reuse_s": reuse_wall, "directory": built}


def doctor() -> dict:
    """``grph-torch doctor`` with every check, through the CLI's entry
    point in this process (the kernels from the checkout's build
    directory); it must return 0."""
    import contextlib
    import io

    from graphphysics_torch.cli.__main__ import main as grph_torch

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = grph_torch(["doctor"])
    wall_s = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"doctor: exit {rc}\n{out.getvalue()}")
    probes = next((json.loads(m.group(0)) for line in lines
                   for m in [re.search(r"\{.*\}", line)] if "throughput probes" in line and m), None)
    return {"rc": rc, "wall_s": wall_s, "probes": probes, "lines": lines}


def utility_phases(clock, counts, seed, epd_frames, tf_frames, cyl_batch, tf_batch, cylinder, panels):
    """Every phase above, each line through ``clock``; returns the launches
    of the exported serving paths, by path, for the kernels' line. The
    checkpoint, profiler and determinism phases share their trainers and
    datasets."""
    from graphphysics_torch.utils.synthetic import cylinder_trajectory, panels_trajectory

    cs = _cs()
    blocks = panels["model"]["message_passing_num"]
    paths = {}
    for label, make, frames, expected, rollout_frames in (
            ("epd", lambda: cs.build_epd(seed, "cuda"), epd_frames, {"csr_segment_sum": cs.BLOCKS},
             EXPORT_ROLLOUT_FRAMES),
            ("transformer", lambda: cs.build_transformer(panels, seed, "cuda"), tf_frames,
             {"csr_attention": blocks}, 0),
            ("transformer_bf16", lambda: cs.build_transformer(cs.with_precision(panels, "bf16"), seed, "cuda"),
             tf_frames, {"csr_attention_bf16": blocks}, 0)):
        result = export_serving(f"export_serving:{label}", make(), frames, counts, expected,
                                rollout_frames)
        paths[f"export_serving:{label}"] = result
        clock.emit({"phase": "export_serving", "model": label, **result})
        torch.cuda.empty_cache()
    cyl_dev, tf_dev = cyl_batch.to("cuda"), tf_batch.to("cuda")
    run = trainer(cylinder, seed)
    for _ in range(2):
        run.train_step(cyl_dev)
    torch.cuda.synchronize()
    clock.emit({"phase": "checkpoint_backends",
                "model": f"EncodeProcessDecode, {cs.CYLINDER_CONFIG}, 8 x 2,048 batch",
                **checkpoint_backends(run, cylinder, cyl_dev, seed)})
    with tempfile.TemporaryDirectory() as tmp:
        families = {}
        for label, param, make_traj in (("epd", cylinder, cylinder_trajectory),
                                        ("transformer", panels, panels_trajectory)):
            os.makedirs(f"{tmp}/{label}")
            families[label] = (param, cs.memory_datasets(param, make_traj, seed, f"{tmp}/{label}",
                                                         n_traj=1)[0])
        profiled, fitted = profiler(families, seed, tmp)
        clock.emit({"phase": "profiler", **profiled})
        bf16 = trainer(cs.with_precision(panels, "bf16"), seed)
        bf16.train_step(tf_dev)
        clock.emit({"phase": "determinism", **determinism(families["epd"][1], (
            ("epd_f32", run, cyl_dev, False), ("transformer_f32", fitted["transformer"], tf_dev, False),
            ("transformer_bf16", bf16, tf_dev, True)))})
    with tempfile.TemporaryDirectory() as tmp:
        clock.emit({"phase": "compilation_cache", **compilation_cache(f"{tmp}/kernel_cache")})
    clock.emit({"phase": "doctor", **doctor()})
    return paths

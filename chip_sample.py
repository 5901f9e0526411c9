#!/usr/bin/env python3
"""Run ``chip_smoke.py`` under a sampling profiler of its main thread.

    python3 chip_sample.py [--out chiprun_out/smoke_samples.json] [--every 0.02]

Every ``--every`` seconds a thread reads the main thread's stack and charges
the time since the last reading to each function on it and to each line of
a ``chip_*.py`` script on it (inclusive seconds). Writes both tables, the
largest first, to ``--out`` as JSON; ``chip_smoke.py``'s own output is
unchanged. Ranks and other processes it starts are not sampled: their time
shows on the line that waits for them. Same card and exit code as
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import threading
import time


def sample(main_id, lines, funcs, stop, every):
    last = time.perf_counter()
    while not stop.is_set():
        time.sleep(every)
        now = time.perf_counter()
        dt, last = now - last, now
        frame = sys._current_frames().get(main_id)
        seen_lines, seen_funcs = set(), set()
        while frame is not None:
            code = frame.f_code
            name = os.path.basename(code.co_filename)
            if name.startswith("chip_") and name.endswith(".py"):
                seen_lines.add(f"{name}:{frame.f_lineno}")
            seen_funcs.add(f"{name}:{code.co_name}")
            frame = frame.f_back
        for k in seen_lines:
            lines[k] += dt
        for k in seen_funcs:
            funcs[k] += dt


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/smoke_samples.json")
    parser.add_argument("--every", type=float, default=0.02)
    args = parser.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke

    lines, funcs = collections.Counter(), collections.Counter()
    stop = threading.Event()
    sampler = threading.Thread(target=sample, args=(threading.get_ident(), lines, funcs, stop, args.every),
                               daemon=True)
    sampler.start()
    sys.argv = [sys.argv[0]]
    try:
        return chip_smoke.main()
    finally:
        stop.set()
        sampler.join()
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"lines": lines.most_common(400), "funcs": funcs.most_common(400)}, f)


if __name__ == "__main__":
    sys.exit(main())

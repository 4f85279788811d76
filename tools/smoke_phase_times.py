#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s seconds go, method by method, on one NVIDIA
card.

  python3 tools/smoke_phase_times.py [--phases N,M,...]

Runs ``chip_smoke.main`` with the same arguments, every method of its
``Smoke`` class wrapped by a timer: for each method, its calls, its wall
seconds and its process CPU seconds (all threads), both inclusive of the
methods it calls.  A method whose CPU seconds are near its wall seconds
is one thread of host time, which a slower host pays in full; one with
several times its wall seconds runs on many cores (the CPU references).
Writes the table, largest wall time first, with the run's total seconds
and the host's CPU count, to ``build/chip_smoke/smoke_phase_times.json``
(nothing without a CUDA device) and exits with ``chip_smoke``'s code.
"""
from __future__ import annotations

import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _timed(table: dict, name: str, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        wall, cpu = time.perf_counter(), time.process_time()
        try:
            return fn(*args, **kwargs)
        finally:
            row = table.setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += time.perf_counter() - wall
            row[2] += time.process_time() - cpu
    return inner


def main(argv: list[str]) -> int:
    sys.path.insert(0, ROOT)
    import chip_smoke
    table: dict = {}
    for name, attr in list(vars(chip_smoke.Smoke).items()):
        if name.startswith("__") or isinstance(attr, (classmethod,
                                                      property)):
            continue
        if isinstance(attr, staticmethod):
            setattr(chip_smoke.Smoke, name,
                    staticmethod(_timed(table, name, attr.__func__)))
        elif callable(attr):
            setattr(chip_smoke.Smoke, name, _timed(table, name, attr))
    t0 = time.perf_counter()
    rc = chip_smoke.main(argv)
    if not table:                   # no card: no phase ran
        return rc
    out = os.path.join(chip_smoke.SMOKE_DIR, "smoke_phase_times.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump({"seconds": time.perf_counter() - t0,
                   "cpus": os.cpu_count(),
                   "methods": {name: {"calls": n, "wall_s": wall,
                                      "cpu_s": cpu}
                               for name, (n, wall, cpu) in sorted(
                                   table.items(), key=lambda kv: -kv[1][1])}},
                  f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

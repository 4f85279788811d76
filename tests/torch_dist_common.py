"""Shared by the port's multi-rank tests (``test_torch_collectives.py``,
``test_torch_fleet_sharded.py``, ``test_torch_ep_a2a.py``,
``test_torch_trainer_dp.py``): a ``torch.distributed`` gloo world on the
CPU, and the JAX package's multi-device reference in a subprocess.

  * :func:`spawn_world` starts ``world`` processes, one a rank, on a
    ``FileStore`` under the test's temporary directory (never a fixed
    port: test files run side by side), each with one thread and
    ``init_process_group(timeout=DEADLINE)``; it runs
    ``module:function(rank, world, **args)`` on each and returns each
    rank's result (``torch.save``-able).  The world is killed when a rank
    fails (the test fails with its output) or at ``DEADLINE`` seconds.
  * :class:`JaxReference` runs a script in a subprocess with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (the flag
    never reaches the test process) that saves its outputs with
    ``np.savez`` to the path in ``OUT`` (its inputs, if any, in the
    ``.npz`` at ``INPUTS``); :meth:`JaxReference.result` loads them (it is
    killed at ``deadline`` seconds, ``DEADLINE`` by default).  Start it
    before the world: the two run side by side.

A rank function's module must not import ``jax`` at its top: every rank
imports it.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
DEADLINE = 120.0          # seconds a world or a reference may take

_BOOT = textwrap.dedent("""
    import sys
    sys.path[:0] = {paths!r}
    from torch_dist_common import _rank_main
    _rank_main(sys.argv[1], int(sys.argv[2]))
""")


def _env(**extra) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", **extra)
    return env


def _rank_main(spec_path: str, rank: int) -> None:
    import datetime
    import importlib

    import torch
    import torch.distributed as dist
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(spec["store"], spec["world"]),
        rank=rank, world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec["deadline"]))
    try:
        module, name = spec["target"].split(":")
        fn = getattr(importlib.import_module(module), name)
        out = fn(rank, spec["world"], **spec["args"])
        torch.save(out, f"{spec['out']}.{rank}")
    finally:
        dist.destroy_process_group()


def spawn_world(target: str, world: int, tmp: Path, args: dict | None = None,
                deadline: float = DEADLINE) -> list:
    """Run ``target`` ("module:function") on every rank of a gloo world of
    ``world`` ranks; returns each rank's result, in rank order."""
    import torch
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec = {"target": target, "world": world, "args": args or {},
            "store": str(tmp / "store"), "out": str(tmp / "out"),
            "deadline": deadline}
    spec_path = tmp / "spec.pkl"
    with open(spec_path, "wb") as f:
        pickle.dump(spec, f)
    boot = _BOOT.format(paths=[str(ROOT / "src"), str(TESTS)])
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", boot, str(spec_path),
                               str(r)], env=_env(), stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    end = time.monotonic() + deadline
    failed, bad = None, []
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.monotonic() > end:
                failed = f"the world ran past its {deadline:.0f} s deadline"
                break
            time.sleep(0.05)
        else:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    if failed:
        r = bad[0] if bad else 0
        logs[r].seek(0)
        text = logs[r].read()[-6000:]
        for log in logs:
            log.close()
        raise AssertionError(f"{target}: {failed}\n{text}")
    for log in logs:
        log.close()
    return [torch.load(f"{spec['out']}.{r}", weights_only=False)
            for r in range(world)]


class JaxReference:
    """The JAX package's multi-device run of ``script`` in a subprocess
    (8 host devices), started at construction."""

    def __init__(self, script: str, tmp: Path,
                 inputs: dict | None = None,
                 deadline: float = DEADLINE) -> None:
        tmp = Path(tmp)
        tmp.mkdir(parents=True, exist_ok=True)
        self.out = tmp / "jax_ref.npz"
        np.savez(tmp / "jax_inputs.npz", **(inputs or {}))
        self.log = open(tmp / "jax_ref.log", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(script)],
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                     OUT=str(self.out),
                     INPUTS=str(tmp / "jax_inputs.npz")),
            stdout=self.log, stderr=subprocess.STDOUT)
        self.start = time.monotonic()
        self.deadline = deadline

    def result(self) -> dict:
        try:
            self.proc.wait(timeout=max(
                1.0, self.deadline - (time.monotonic() - self.start)))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.log.seek(0)
        text = self.log.read()[-6000:]
        self.log.close()
        assert self.proc.returncode == 0, f"JAX reference failed:\n{text}"
        with np.load(self.out) as z:
            return {k: z[k] for k in z.files}

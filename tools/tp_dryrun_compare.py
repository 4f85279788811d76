#!/usr/bin/env python3
"""The reference's and the port's dry-run terms side by side on a reduced
mesh, on the CPU.

  PYTHONPATH=src python3 tools/tp_dryrun_compare.py

The reduced dense config of tests/test_torch_dryrun.py (qwen3-0.6b's with
d 1024, 2 layers, d_ff 2048, vocab 4096, H 8, KV 4, float32, no remat) at
B 4, S 16 on a (data 2, model 4) mesh, prefill and train, each with
``seq_parallel`` off and on:

  * the reference: ``repro.launch.dryrun._corrected_costs`` on 8 host
    devices (a subprocess; GSPMD's automatic axes): XLA's cost analysis
    (flops, bytes accessed) and ``collective_bytes`` of its 1- and 2-unit
    unrolled compiles, extrapolated to the layers, and the collective op
    counts of the scanned program's HLO;
  * the port: ``repro_torch.launch.dryrun.run_step`` as rank 0 of a fake
    world of 8.

Prints one JSON object: {run: {"reference": ..., "port": ...}}.  The two
are not expected to be equal: GSPMD picks its own collectives, XLA counts
fused bytes and its CPU backend upcasts, and a train step's reference
cost covers the optimizer's update the same way as the port's.
"""
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(d_model=1024, num_layers=2, d_ff=2048, vocab_size=4096,
            num_heads=8, num_kv_heads=4, head_dim=64, dtype="float32",
            remat="none")
B, S = 4, 16
RUNS = [(kind, sp) for kind in ("prefill", "train") for sp in (False, True)]

_REFERENCE = """
import json
import jax
from repro.configs.base import InputShape
from repro.configs.registry import ARCHS
from repro.launch import dryrun
BASE, B, S, RUNS = {base!r}, {b}, {s}, {runs!r}
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {{}}
for kind, sp in RUNS:
    cfg = ARCHS["qwen3-0.6b"].reduced().with_overrides(**BASE,
                                                       seq_parallel=sp)
    shape = InputShape(kind, S, B, kind)
    cost = dryrun._corrected_costs(cfg, shape, mesh, "full")
    hlo = dryrun._build_lowered(cfg, shape, mesh, "full").compile().as_text()
    cost["hlo_ops"] = {{k: hlo.count(f" {{k}}(") for k in
                        ("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute")}}
    out[f"{{kind}}_{{int(sp)}}"] = cost
print(json.dumps(out))
"""


def reference() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    script = textwrap.dedent(_REFERENCE.format(base=BASE, b=B, s=S,
                                               runs=RUNS))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    return json.loads(proc.stdout.strip().splitlines()[-1])


def port() -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun
    mesh = dryrun.fake_world((2, 4), ("data", "model"))
    out = {}
    for kind, sp in RUNS:
        cfg = ARCHS["qwen3-0.6b"].reduced().with_overrides(**BASE,
                                                           seq_parallel=sp)
        cost, rec, memory, _ = dryrun.run_step(cfg, InputShape(kind, S, B,
                                                               kind), mesh)
        wire, _ = dryrun.collective_seconds(rec, mesh)
        out[f"{kind}_{int(sp)}"] = {
            **cost, "collectives": wire,
            "hlo_ops": {k: n for k, n in rec.calls.items() if n},
            "memory": memory}
    return out


def main() -> int:
    ref, got = reference(), port()
    print(json.dumps({k: {"reference": ref[k], "port": got[k]}
                      for k in got}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

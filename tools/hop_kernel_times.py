#!/usr/bin/env python3
"""Time the ASCII hop's two kernels of one checkout on one NVIDIA card.

  python3 tools/hop_kernel_times.py [ROOT]   # ROOT: a checkout (default: .)

Imports ``repro_torch`` from ROOT/src (its kernels build under ROOT/build)
and prints one JSON line: the card's name and power limit, the checkout,
and for the ignorance update at n = 10500, 42000, 2^16, 2^16 + 1, 2^18 and
2^20 and the quantize-dequant at (42000,), (18000, 10) and (2^20 + 3,):
call ms (CUDA events around 200 back-to-back calls), device ms
(torch.profiler's kernel durations a call, all kernels of the call) and
device kernels a call.  It calls ``repro_torch.kernels.ops``, whose API
the two-pass kernels and the one-launch kernels share, on inputs made from
one seed.  Where the checkout has them, it also times the empty kernel of
``csrc/ignorance.cu`` and, under ``cluster_limit_8``, the one-launch
kernels with their plans held to the portable cluster of 8.  To compare two
checkouts, run it on each within one call on one card, in turns (A, B, B,
A).  It exits 2 when torch sees no CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    root = os.path.abspath(argv[0] if argv else HERE)
    import torch
    if not torch.cuda.is_available():
        print("hop_kernel_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, HERE)
    from chip_smoke import (_cuda_time_ms, _device_kernels_per_call,
                            _kernel_device_ms)
    from repro_torch.kernels import ignorance as ig
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()

    def row(fn) -> dict:
        per_call, _ = _device_kernels_per_call(fn)
        return {"ms": _cuda_time_ms(fn), "device_ms": _kernel_device_ms(fn, ""),
                "kernels_a_call": per_call}

    inputs = {}
    for n in (10500, 42000, 2 ** 16, 2 ** 16 + 1, 2 ** 18, 2 ** 20):
        w = torch.rand(n, generator=gen, device=dev) + 0.01
        w /= w.sum()
        r = (torch.rand(n, generator=gen, device=dev) > 0.4).float()
        inputs[n] = (w, r, torch.tensor(1.7, device=dev))
    for shape in ((42000,), (18000, 10), (2 ** 20 + 3,)):
        inputs[shape] = (torch.rand(shape, generator=gen, device=dev) - 0.3,
                         torch.rand(shape, generator=gen, device=dev))

    def times(keys) -> dict:
        got = {}
        for key in keys:
            if isinstance(key, int):
                w, r, a = inputs[key]
                got[key] = row(lambda: ops.ignorance_update(w, r, a))
            else:
                x, u = inputs[key]
                fn = ops.quantize_dequant_block if len(key) == 2 \
                    else ops.quantize_dequant
                got[str(list(key))] = row(lambda: fn(x, u, 127.0))
        return got

    out = {"card": card, "root": root, "times": times(inputs)}
    from repro_torch.kernels import quantize as q
    if hasattr(ig, "cluster_limit") and hasattr(q, "cluster_limit"):
        for mod in (ig, q):
            mod.cluster_limit(dev.index or 0)  # allow the card its limit
            mod.cluster_limit = lambda index: 8
        out["cluster_limit_8"] = times((10500, 42000, 2 ** 16, (42000,),
                                        (18000, 10)))
    if hasattr(ig, "launch_floor"):
        out["launch_floor"] = {}
        for cluster in (1, 8):
            def floor():
                ig.launch_floor(dev, cluster)
            out["launch_floor"][cluster] = {
                "ms": _cuda_time_ms(floor),
                "device_ms": _kernel_device_ms(floor, "empty_kernel")}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

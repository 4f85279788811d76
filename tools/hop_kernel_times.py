#!/usr/bin/env python3
"""Time the ASCII hop's kernels of one checkout on one NVIDIA card.

  python3 tools/hop_kernel_times.py [ROOT]   # ROOT: a checkout (default: .)

Imports ``repro_torch`` from ROOT/src (its kernels build under ROOT/build)
and prints one JSON line: the card's name and power limit, the checkout,
and for the ignorance update at n = 10500, 42000, 2^16, 2^16 + 1, 2^18 and
2^20 and the quantize-dequant at (42000,), (18000, 10) and (2^20 + 3,):
call ms (CUDA events around 200 back-to-back calls), device ms
(torch.profiler's kernel durations a call, all kernels of the call) and
device kernels a call.  It calls ``repro_torch.kernels.ops``, whose API
the two-pass kernels and the one-launch kernels share, on inputs made from
one seed; the int4 codec's ``encode`` and ``decode`` at (42000,) and
(18000, 10) through ``QuantCodec(bits=4)``, whose API the separate
quantize, pack and unpack passes and the fused wire kernels share; and
the standalone ``pack_int4`` and ``unpack_int4`` at 42000.  Where
the checkout has them, it also times the empty kernel of
``csrc/ignorance.cu``; under ``cluster_limit_8``, the one-launch kernels
with their plans held to the portable cluster of 8; and under
``int4_host_path``, each part of the fused int4 wrappers' host path at n =
42000 (host clock, microseconds a call, over 2000 calls).  To compare two
checkouts, run it on each within one call on one card, in turns (A, B, B,
A).  It exits 2 when torch sees no CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
    from repro_torch.comm.codecs import QuantCodec
    int4 = QuantCodec(bits=4)
    for shape in ((42000,), (18000, 10)):
        x, u = inputs[shape]
        draws = _Draws(u)
        wire, _ = int4.encode(x, draws)
        out["times"][f"int4_encode{list(shape)}"] = row(
            lambda: int4.encode(x, draws))
        out["times"][f"int4_decode{list(shape)}"] = row(
            lambda: int4.decode(wire))
        if shape == (42000,):       # the standalone kernels on its q
            q4 = ops.unpack_int4(wire[0], 42000)
            out["times"]["pack_int4[42000]"] = row(lambda: ops.pack_int4(q4))
            out["times"]["unpack_int4[42000]"] = row(
                lambda: ops.unpack_int4(wire[0], 42000))
    from repro_torch.kernels import quantize as q
    if hasattr(q, "quantize_pack_int4"):
        out["int4_host_path"] = _int4_host_path(q, *inputs[(42000,)])
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


class _Draws:
    """The codec's draws: the same uniforms on every call."""

    def __init__(self, u):
        self.u = u

    def uniform(self, shape, device):
        return self.u


def _host_us(fn, reps: int = 2000) -> float:
    """Host clock a call of ``fn`` over ``reps`` calls, after a warm-up;
    the launches it queues are waited for outside the window."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def _int4_host_path(q, x, u) -> dict:
    """Each part of the fused int4 encode's and decode's host path at one
    global tile of n elements: the wrapper's whole call, its input checks,
    its output allocations, the card's plan and stream, the tensors'
    pointers and the ctypes call with its arguments ready."""
    import torch
    n, dev = x.numel(), x.device
    tile = n
    packed, scales = q.quantize_pack_int4(x, u, 7.0, tile)
    xhat = q.unpack_dequant_int4(packed, scales, n, tile)
    lib, limit = q._lib(), q.cluster_limit(dev.index or 0)
    p, inv, stream = q.plan(tile, limit), q.inv_qmax(7.0), q.raw_stream(dev)
    ptrs = [t.data_ptr() for t in (x, u, packed, scales, xhat)]

    def encode_checks():
        q._check_qmax(7.0, 7.0)
        q._check_tile(n, tile)
        q._check("x", x, torch.float32, tuple(x.shape), dev)
        q._check("u", u, torch.float32, tuple(x.shape), dev)
        q.on_card(x, "quantize_pack_int4")

    def decode_checks():
        q._check_wire(packed, n)
        q._check_tile(n, tile)
        q._check("scales", scales, torch.float32, (n // tile,), dev)
        q.on_card(packed, "unpack_dequant_int4")

    def plan_and_stream():
        with q.current(dev):
            q.plan(tile, q.cluster_limit(dev.index))
            q.inv_qmax(7.0)
            q.raw_stream(dev)

    def stream_only():
        with q.current(dev):
            q.raw_stream(dev)

    encode = {
        "call": _host_us(lambda: q.quantize_pack_int4(x, u, 7.0, tile)),
        "checks": _host_us(encode_checks),
        "allocate": _host_us(lambda: (
            torch.empty((n + 1) // 2, dtype=torch.int8, device=dev),
            torch.empty(n // tile, dtype=torch.float32, device=dev))),
        "plan_and_stream": _host_us(plan_and_stream),
        "data_ptrs": _host_us(lambda: (x.data_ptr(), u.data_ptr(),
                                       packed.data_ptr(),
                                       scales.data_ptr())),
        "ctypes_call": _host_us(lambda: lib.quantize_pack_int4(
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], n, tile, p.cluster,
            p.per_cta, 7.0, inv, stream))}
    decode = {
        "call": _host_us(lambda: q.unpack_dequant_int4(packed, scales, n,
                                                       tile)),
        "checks": _host_us(decode_checks),
        "allocate": _host_us(lambda: torch.empty(n, dtype=torch.float32,
                                                 device=dev)),
        "plan_and_stream": _host_us(stream_only),
        "data_ptrs": _host_us(lambda: (packed.data_ptr(), scales.data_ptr(),
                                       xhat.data_ptr())),
        "ctypes_call": _host_us(lambda: lib.unpack_dequant_int4(
            ptrs[2], ptrs[3], ptrs[4], n, tile, stream))}
    for parts in (encode, decode):
        parts["rest"] = parts["call"] - sum(v for k, v in parts.items()
                                            if k != "call")
    return {"n": n, "unit": "us a call, host clock", "encode": encode,
            "decode": decode}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

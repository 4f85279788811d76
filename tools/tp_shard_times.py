#!/usr/bin/env python3
"""Time the tensor-parallel shard kernels of one checkout, and the whole
kernels beside them, on one NVIDIA card.

  python3 tools/tp_shard_times.py [--serve] [ROOT]
  # ROOT: a checkout (default: .)

Imports ``repro_torch`` from ROOT/src (its kernels build under ROOT/build)
and prints one JSON line: the card's name and power limit, the checkout,
``serve`` (below), and device ms (a CUDA graph of the launches replayed
between two CUDA events, ``chip_smoke._graph_ms``) of

  * ``ce``: qwen3-0.6b's 2048 x 151936 bf16 logits, the forward and the
    backward over 16 vocab shards of 9496 (a shard's share of the 16
    launches; chip_smoke 21(a)'s method) and the whole-vocab kernels;
  * ``decode``: decode_32k's cache (B 8, H 16, KV 8, D 128 bf16, the
    model's [B, S, KV, D] layout) at pos 32767, a chunk's share of 16
    chunks of 2048 (21(b)'s method), and the whole cache; the serve step
    (B 4, S 576, pos 575) whole.

``serve`` (alone with ``--serve``): ``flash_decode`` at the serve step
in bf16 and on an int8 cache, three rounds of its call ms (CUDA events
around 100 calls, chip_smoke phase 8's ``ms``: host time, as the serve
decode is host-bound) and its device ms.

Where the checkout has the cluster kernel (``flash_decode._launch``), it
also times, in turns, a chunk of 21(b) on the split kernel with its
one-pass plan and with the cluster kernel's plan (``plan_alone``: the
plan's share of the gain apart from the kernel's), and the three at
batch 1, 2 and 4 (``small_grids``); the whole-cache call on the split
kernel's plan, the split kernel on the cluster kernel's plan and the
cluster kernel at the serve step in float32, bf16 and int8 and on the
32k cache (``whole_by_route``) and over batch 1-8 and caches of
576-32768 (``whole_grid``: where ``decode_plan``'s line falls); and the
shard forward's staged kernel at other plans, both forward kernels on
contiguous copies of the shards and against rows and width
(``ce_staged``).  To compare two checkouts, run it on each within one
call on one card, in turns (A, B, B, A).  It exits 2 when torch sees no
CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv: list[str]) -> int:
    serve_only = "--serve" in argv
    argv = [a for a in argv if a != "--serve"]
    root = os.path.abspath(argv[0] if argv else HERE)
    import torch
    if not torch.cuda.is_available():
        print("tp_shard_times: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(1, HERE)
    from chip_smoke import _graph_ms
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops
    from repro_torch.kernels import weighted_ce as wce
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out = {"card": card, "root": root,
           "serve": _serve_times(torch, fd, gen, dev)}
    if serve_only:
        print(json.dumps(out), flush=True)
        return 0

    t, v, parts = 2048, 151936, 16
    v_loc = v // parts
    x = (torch.randn(t, v, generator=gen, device=dev) * 2).to(torch.bfloat16)
    lab = torch.randint(0, v, (t,), generator=gen, device=dev,
                        dtype=torch.int32)
    w = torch.rand(t, generator=gen, device=dev) + 0.5
    g = torch.rand(t, generator=gen, device=dev) + 0.5
    cols = [x[:, r * v_loc:(r + 1) * v_loc] for r in range(parts)]
    _, lse = wce.weighted_ce_fwd(x, lab, w)
    if hasattr(wce, "shard_fwd_plan"):
        out["ce_staged"] = _ce_diagnostics(torch, wce, x, cols, lab, v_loc)
    out["ce"] = {
        "shard_fwd": _graph_ms(lambda: [ops.weighted_ce_shard_fwd(
            c, lab, r * v_loc) for r, c in enumerate(cols)], 50) / parts,
        "shard_bwd": _graph_ms(lambda: [ops.weighted_ce_shard_bwd(
            c, lab, w, lse, g, r * v_loc) for r, c in enumerate(cols)],
            50) / parts,
        "whole_fwd": _graph_ms(lambda: wce.weighted_ce_fwd(x, lab, w), 50),
        "whole_bwd": _graph_ms(lambda: wce.weighted_ce_bwd(x, lab, w, lse,
                                                           g), 50)}
    del x, cols

    def cache(b, h, kv, s, d):
        q = torch.randn(b, h, d, generator=gen, device=dev).to(torch.bfloat16)
        k, vv = (torch.randn(b, s, kv, d, generator=gen, device=dev).to(
            torch.bfloat16).transpose(1, 2) for _ in range(2))
        return q, k, vv

    n, pos = 2048, 32767
    q, k, vv = cache(8, 16, 8, 32768, 128)

    def chunk_ms(call, qq=q, kk=k, vv=vv):
        return _graph_ms(lambda: [call(
            qq, kk[:, :, r * n:(r + 1) * n], vv[:, :, r * n:(r + 1) * n],
            pos, r * n) for r in range(parts)], 50) / parts

    out["decode"] = {
        "shard_chunk": chunk_ms(ops.flash_decode_shard),
        "whole_32k": _graph_ms(lambda: fd.flash_decode(q, k, vv, pos), 50)}
    qs, ks, vs = cache(4, 16, 8, 576, 128)
    out["decode"]["whole_serve"] = _graph_ms(
        lambda: fd.flash_decode(qs, ks, vs, 575), 50)

    if hasattr(fd, "_launch"):
        pass_rows = fd.rows_per_pass(torch.bfloat16, 128)
        sms = fd.sm_count(dev.index or 0)

        def planned(kernel, plan_of):
            def call(qq, kk, vv_, p, s0):
                lo, hi = fd.valid_range(p, kk.shape[2], None, s0)
                blocks = qq.shape[0] * qq.shape[1] // 2
                return fd._launch(kernel, qq, kk, vv_, None, None, lo, hi,
                                  *plan_of(lo, hi, blocks, sms, pass_rows),
                                  2, True)
            return call

        one_pass = planned("flash_decode", fd.split_plan)
        multi = planned("flash_decode", fd.cluster_plan)
        cluster = planned("flash_decode_cluster", fd.cluster_plan)
        turns = {"split_one_pass_plan": [], "split_cluster_plan": [],
                 "cluster": []}
        for name in [*turns, *reversed(turns)]:
            turns[name].append(chunk_ms({
                "split_one_pass_plan": one_pass,
                "split_cluster_plan": multi, "cluster": cluster}[name]))
        out["plan_alone"] = turns
        small = {}
        for b in (1, 2, 4):
            qb, kb, vb = q[:b], k[:b], vv[:b]
            small[str(b)] = {
                "route": fd.decode_plan(0, n - 1, b * 16 // 2, sms,
                                        pass_rows)[0],
                "split": chunk_ms(one_pass, qb, kb, vb),
                "split_cluster_plan": chunk_ms(multi, qb, kb, vb),
                "cluster": chunk_ms(cluster, qb, kb, vb)}
        out["small_grids"] = small

        # The whole-cache call on three routes: the split kernel on its
        # own plan, the split kernel on the cluster kernel's plan (the plan
        # without the cluster's merge), and the cluster kernel.
        routes = {"split": ("flash_decode", fd.split_plan),
                  "split_cluster_plan": ("flash_decode", fd.cluster_plan),
                  "cluster": ("flash_decode_cluster", fd.cluster_plan)}

        def whole(qq, kk, vv_, p, route, scales=(None, None)):
            kernel, plan_of = routes[route]
            lo, hi = fd.valid_range(p, kk.shape[2], None)
            blocks = qq.shape[0] * qq.shape[1] // 2
            plan = plan_of(lo, hi, blocks, sms,
                           fd.rows_per_pass(kk.dtype, qq.shape[2]))
            return _graph_ms(lambda: fd._launch(
                kernel, qq, kk, vv_, *scales, lo, hi, *plan, 2, False), 50)

        qf, kf, vf = (x.float() for x in (qs, ks, vs))
        k8, v8 = ((x * 40).round().clamp(-127, 127).to(torch.int8)
                  for x in (ks, vs))
        sc = (torch.full((4, 8, 576), 1 / 40, device=dev),) * 2
        serve = {f"{dt}_{r}": [] for dt in ("f32", "bf16", "int8")
                 for r in routes}
        order = [*routes, *reversed(routes)]
        for r in order:
            serve[f"f32_{r}"].append(whole(qf, kf, vf, 575, r))
            serve[f"bf16_{r}"].append(whole(qs, ks, vs, 575, r))
            serve[f"int8_{r}"].append(whole(qs, k8, v8, 575, r, sc))
        by_route = {"serve": serve, "32k": {r: [] for r in routes}}
        for r in order:
            by_route["32k"][r].append(whole(q, k, vv, pos, r))
        out["whole_by_route"] = by_route
        grid = {}
        for b in (1, 2, 4, 8):
            for s in (576, 2048, 4096, 8192, 32768):
                qq, kk, vx = q[:b], k[:b, :, :s], vv[:b, :, :s]
                cell = {r: [] for r in routes}
                for r in order:
                    cell[r].append(whole(qq, kk, vx, s - 1, r))
                grid[f"B{b}_S{s}"] = cell
        out["whole_grid"] = grid
    print(json.dumps(out), flush=True)
    return 0


def _serve_times(torch, fd, gen, dev) -> dict:
    """``flash_decode`` at the serve step (B 4, H 16, KV 8, S 576, D 128,
    pos 575) on a bf16 and an int8 cache: three rounds, in turns, of its
    call ms and its device ms."""
    from chip_smoke import _cuda_time_ms, _graph_ms
    q = torch.randn(4, 16, 128, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(4, 576, 8, 128, generator=gen, device=dev)
            for _ in range(2))
    sc = torch.full((4, 576, 8), 1 / 40, device=dev).transpose(1, 2)
    kb, vb = (x.to(torch.bfloat16).transpose(1, 2) for x in (k, v))
    k8, v8 = ((x * 40).round().clamp(-127, 127).to(torch.int8).transpose(
        1, 2) for x in (k, v))
    calls = {"bf16": lambda: fd.flash_decode(q, kb, vb, 575),
             "int8": lambda: fd.flash_decode(q, k8, v8, 575, k_scale=sc,
                                             v_scale=sc)}
    got = {f"{name}_{kind}": [] for name in calls
           for kind in ("call_ms", "device_ms")}
    for _ in range(3):
        for name, fn in calls.items():
            got[f"{name}_call_ms"].append(_cuda_time_ms(fn, reps=100))
            got[f"{name}_device_ms"].append(_graph_ms(fn, 50))
    return got


def _ce_diagnostics(torch, wce, x, cols, lab, v_loc) -> dict:
    """The shard forward's 16 shards on the staged kernel at other plans
    (blocks an SM, stages), and both forward kernels on contiguous copies
    of the shards (the same bytes without the whole vocab's row stride):
    device ms a shard."""
    from chip_smoke import _graph_ms
    from repro_torch.kernels._launch import sm_count
    lib = wce._lib()
    parts = len(cols)
    sms = sm_count(x.device.index or 0)
    gold = torch.empty(x.shape[0], device=x.device)
    lse = torch.empty_like(gold)

    def launch(c, r, plan):
        args = (c.data_ptr(), 1, lab.data_ptr(), gold.data_ptr(),
                lse.data_ptr(), c.shape[0], c.shape[1], c.stride(0),
                r * v_loc)
        stream = torch.cuda.current_stream().cuda_stream
        status = (lib.weighted_ce_shard_fwd(*args, stream) if plan is None
                  else lib.weighted_ce_shard_fwd_staged(*args, *plan,
                                                        stream))
        if status != 0:
            raise RuntimeError(f"launch failed: {status} ({plan})")

    def ms(shards, plan):
        return _graph_ms(lambda: [launch(c, r, plan)
                                  for r, c in enumerate(shards)], 50) / parts

    stage = -(-v_loc * 2 // 128) * 128
    got = {}
    for per_sm, stages in ((1, 4), (2, 2), (2, 3), (2, 4), (3, 2), (3, 3),
                           (4, 2)):
        got[f"strided_{per_sm}x{stages}"] = ms(
            cols, (per_sm * sms, stages, stage))
    t = x.shape[0]
    for per_sm in (2, 3):       # the same rows on every block
        grid = -(-t // -(-t // (per_sm * sms)))
        got[f"strided_{per_sm}x2_even_{grid}"] = ms(cols, (grid, 2, stage))
    got["strided_stream"] = ms(cols, None)
    dense = [c.contiguous() for c in cols]
    got["dense_2x4"] = ms(dense, (2 * sms, 4, stage))
    got["dense_stream"] = ms(dense, None)
    del dense
    # time against rows and width, on dense copies: where the per-launch,
    # per-row and per-byte costs lie
    for rows in (1024, 2048, 4096):
        for width in (4744, 9496, 18992):
            xs = [torch.randn(rows, width, device=x.device).to(x.dtype)
                  for _ in range(parts)]
            labs = lab[:rows]
            st = -(-width * 2 // 128) * 128
            plan = (min(rows, 2 * sms), min(4, 96 * 1024 // st), st)

            def go(kernel_plan, xs=xs, labs=labs):
                def launch_one(c, r):
                    args = (c.data_ptr(), 1, labs.data_ptr(),
                            gold.data_ptr(), lse.data_ptr(), c.shape[0],
                            c.shape[1], c.stride(0), r * width)
                    stream = torch.cuda.current_stream().cuda_stream
                    status = (lib.weighted_ce_shard_fwd(*args, stream)
                              if kernel_plan is None else
                              lib.weighted_ce_shard_fwd_staged(
                                  *args, *kernel_plan, stream))
                    if status != 0:
                        raise RuntimeError(f"launch failed: {status}")
                return _graph_ms(lambda: [launch_one(c, r) for r, c in
                                          enumerate(xs)], 20) / parts
            got[f"T{rows}_V{width}"] = {"staged": go(plan),
                                        "stream": go(None)}
            del xs
    return got


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

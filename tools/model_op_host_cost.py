#!/usr/bin/env python3
"""Host cost of calling the model path's kernels through their
``torch.library`` custom ops, on one NVIDIA card.

  python3 tools/model_op_host_cost.py

``repro_torch.kernels.ops`` calls flash attention, flash decode (and its
shard mode) and the weighted CE directly for card and CPU tensors, and
through their custom ops for meta tensors only (the dry run).  This times
both routes on the card, the custom-op route by making every model-path
wrapper take its meta branch (``ops._meta``):

  * qwen3-0.6b at full width (28 layers, bfloat16, ``use_flash``, random
    weights from seed 0), batch 1: a 256-token prefill, then 64
    teacher-forced decode steps; host ms a token (wall clock, the card
    synchronised after each step), the median over the steps;
  * ``ops.flash_decode`` alone at that decode's shape (q [1, 16, 128]
    against a [1, 8, 320, 128] bfloat16 cache): host microseconds a call
    over 2000 calls, the card synchronised once at the end.

The routes run in turns (direct, custom op, custom op, direct), and the
two must give the same logits bit for bit.  Prints one JSON line with the
card's name and power limit.  It exits 2 when torch sees no CUDA device.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT, STEPS, CALLS = 256, 64, 2000


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("model_op_host_cost: torch sees no CUDA device",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.models import api
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    cfg = ARCHS["qwen3-0.6b"].with_overrides(use_flash=True)
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT), generator=gen,
                           device=dev)
    follow = torch.randint(0, cfg.vocab_size, (1, STEPS), generator=gen,
                           device=dev)
    serve = api.make_serve_step(cfg)

    def decode() -> tuple[list, list]:
        """Per-step host ms and logits of the prefill and STEPS steps."""
        with torch.no_grad():
            logits, caches = api.make_prefill_step(cfg)(
                params, {"tokens": tokens})
            caches = api.pad_prefill_cache(caches, cfg, PROMPT + STEPS)
            torch.cuda.synchronize()
            seq, ms = [logits], []
            for i in range(STEPS):
                t0 = time.perf_counter()
                _, lg, caches = serve(params, caches, follow[:, i:i + 1],
                                      PROMPT + i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                seq.append(lg)
        return ms, seq

    q = torch.randn(1, 16, 128, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(1, PROMPT + STEPS, 8, 128, generator=gen, device=dev
                        ).to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))

    def per_call_us() -> float:
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                ops.flash_decode(q, k, v, PROMPT + STEPS - 1)
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6 / CALLS

    def run(route: str) -> dict:
        patch = (mock.patch.object(ops, "_meta", lambda x: True)
                 if route == "custom_op" else mock.patch.object(
                     ops, "_meta", ops._meta))
        with patch:
            decode()                                  # warm: builds, caches
            ms, seq = decode()
            per_call_us()
            us = per_call_us()
        return {"route": route, "decode_ms_token": statistics.median(ms),
                "decode_ms_token_mean": statistics.fmean(ms),
                "flash_decode_us_call": us, "seq": seq}

    runs = [run(r) for r in ("direct", "custom_op", "custom_op", "direct")]
    same = all(torch.equal(a, b) for r in runs[1:]
               for a, b in zip(runs[0]["seq"], r["seq"]))
    for r in runs:
        del r["seq"]

    def mean(route: str, key: str) -> float:
        return statistics.fmean(r[key] for r in runs if r["route"] == route)
    out = {"card": card, "arch": "qwen3-0.6b", "batch": 1, "prompt": PROMPT,
           "steps": STEPS, "runs": runs, "same_logits": same,
           "decode_ms_token": {r: mean(r, "decode_ms_token")
                               for r in ("direct", "custom_op")},
           "flash_decode_us_call": {r: mean(r, "flash_decode_us_call")
                                    for r in ("direct", "custom_op")}}
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card, in phases.

  python3 chip_smoke.py            # from the root of a checkout
  python3 chip_smoke.py --phases 1,8   # those phases only, no result line

1. Prints the card's name and power limit; builds the CUDA kernels from
   src/repro_torch/csrc with nvcc (all sources at once) and times the build;
   prints ``flash_ptxas`` and ``hop_ptxas`` (registers and spill bytes of
   every flash, ignorance and quantize kernel instantiation, from
   ``-Xptxas=-v``) and fails if one spills, or unless ``cuobjdump -sass``
   finds tensor-core instructions (HGMMA or HMMA) in the flash_attention
   library.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's sizes, at both sides of each boundary of the launch plans
   and beyond, bit for bit, two runs identical: the ignorance update (one
   cluster launch; its unnormalized mode in w_new and the partials), and
   the wire channel's quantize-dequant (vectors and score blocks; one
   launch), int4 pack and unpack.  Prints each plan (``ignorance_plans``,
   ``quantize_plans``: cluster size and CTAs), checks with torch.profiler
   that the update at n = 42000 and the quantize-dequant at 42000 and
   [18000, 10] are one device kernel a call, and times kernel (call ms and
   device ms), plain version and bound (``kernel_table``,
   ``quantize_table``) and an empty kernel launched the same way
   (``launch_floor``, plain and as a cluster of 8); times the copy of a
   hop's channel draws to the card.
3. Runs the session CLI path (blob3, tree agents) with the metered and the
   mesh-ring transport: the kernels' launch counts equal the hop count, the
   ledger equals the Fig.-4 formula, and a session paused after 2 rounds
   and resumed ends with an ignorance vector bit-identical to an
   uninterrupted run.
4. Full size, MIMIC-III surrogate (paper Fig. 3): 15000 rows (10500 train),
   agents of 3 and 13 features, depth-4 trees, 10 rounds; the same session
   on the CPU (plain version) must agree.
5. Full size, Fashion-MNIST surrogate halves (paper Fig. 5): 60000 images
   (42000 train), 2 agents of 392 pixels, 300-step logistic regression, 5
   rounds; ASCII must beat the single agent.
6. MIMIC size through the wire channel, the session CLI's transports
   (--codec int8; --codec int4 --serve-codec int8; --codec topk;
   --dp-epsilon 1 --accountant rdp; a --byte-budget that walks the ladder
   to int4 and ends exhausted), each on the card and on the CPU with the
   same channel draws: ledgers equal and equal to the wire_bits formulas,
   stop rounds and predictions equal, alphas within rtol 1e-5, quantize
   launches = int-codec hops and score blocks.
7. Fashion at full width with --codec int8 --serve-codec int4 on the card:
   ledger = wire_bits, the first alpha = phase 5's, the int4 and int8
   codecs' encode -> decode (quantize, pack, unpack) of a real hop's w
   equal their roundtrip within one step; accuracy beside phase 5's.
8. The model zoo's kernels against their plain versions on the card at
   the dense models' shapes: qwen3-0.6b (B 4, H 16, KV 8, D 128),
   h2o-danube-3-4b (B 2, H 32, KV 8, D 120, a window of 128 that bites at
   S 512) and gemma-7b (B 2, H = KV = 16, D 256); float32 (within 2e-5
   max|v|) and bfloat16 (within 2^-7 max|v|), two runs the same bits,
   with the model's strided layouts: flash attention at S = T = 512, a
   ragged S = T = 500, right-aligned S 500 < T 512, a window of 128; flash
   decode against a cache of 576 at pos 0, 511, 575, fp and int8, with and
   without a window.  Checks that the decode grid at the serve shape puts
   2 or more blocks on each SM.  Prints ``flash_table`` (bf16, per model):
   call ms (CUDA events), device_ms (torch.profiler's kernel durations a
   call, L2 warm) and device_ms_cold (the same over copies of the inputs
   that exceed the 50 MB L2), plain version, bound, and
   F.scaled_dot_product_attention's call and device ms (the library
   yardstick; a boolean mask for a window or a cache position).
9. Full-width serve, qwen3-0.6b (28 layers, bf16, random weights) through
   ``repro_torch.launch.serve --no-reduced --use_flash``: batch 4, prompt
   512, 64 tokens, once plain and once with --kv_quant; one flash_attention
   launch per layer per prefill and one flash_decode launch per layer per
   decode step.  Then, on the same weights and tokens, teacher-forced
   against use_flash=False (the einsum attention) with the weights in
   float32: the float32 flash path within 1e-4 max|logits| (1e-3 with the
   int8 cache) at every step, and the bf16 flash path no further from it
   than 1.25 x the bf16 einsum path (two bf16 evaluations of 28 random
   layers differ by ~4 % of max|logits|, see PERF.md).  Prints prefill ms,
   decode ms per step, tokens/s and peak device memory.
10. The weighted-CE kernels against their plain versions on the card:
   qwen3-0.6b's training logits [8, 256, 151936] bf16 and the 100m
   preset's [8, 256, 32000] float32, handed over as the loss hands them
   (B * S rows, weight 0 at each last position), and the ragged (2040,
   1000) and (7, 3) in both dtypes: loss and lse within rtol 1e-5,
   dlogits within 2^-7 max|dlogits| (bf16) and 1e-5 max|dlogits|
   (float32), two runs the same bits.  Prints ``ce_table``: kernel, plain
   version, F.cross_entropy (forward; backward through autograd) and bound
   ms at the two training shapes.
11. Full-width training, qwen3-0.6b (28 layers, bf16, 596049920 params,
   random weights) through ``repro_torch.launch.train``: batch 8, seq 256,
   20 steps; every loss finite, one launch of each weighted-CE kernel per
   step; prints step ms, tokens/s, peak device memory, loss first -> last
   and a ``train_profile`` line (torch.profiler over two steps).  On the
   trained weights and a fresh batch, the kernel loss and its gradients
   against the plain loss's on the same logits (loss rtol 1e-5, global
   gradient norm rtol 1e-2).  Then ``--preset 100m --steps 300`` (float32,
   the reference example's run): its loss falls.

Every phase prints one line; a failed phase makes the run exit 1, and then
the last line is not printed.  Before the last line it prints the card's
line again and one JSON object describing each kernel.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits 2 when torch sees no CUDA device, and fails to import the port when
run outside a checkout.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor-core rate
SMOKE_DIR = os.path.join(ROOT, "build", "chip_smoke")


def _cuda_time_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _counters() -> dict:
    """Each kernel of the main path by its JSON name: the wrapper that
    counts its launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ignorance as ig
    from repro_torch.kernels import quantize as q
    from repro_torch.kernels import weighted_ce as wce
    return {"ignorance_update": ig.ignorance_update,
            "ignorance_update_unnormalized": ig.ignorance_update_unnormalized,
            "quantize_dequant_tiles": q.quantize_dequant_tiles,
            "quantize_dequant_block": q.quantize_dequant_block,
            "pack_int4": q.pack_int4,
            "unpack_int4": q.unpack_int4,
            "flash_attention": fa.flash_attention,
            "flash_decode": fd.flash_decode,
            "weighted_ce_fwd": wce.weighted_ce_fwd,
            "weighted_ce_bwd": wce.weighted_ce_bwd}


def _bound_ms(nbytes: int, ops: int,
              ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_pairs(s: int, t: int, causal: bool, window) -> int:
    """Unmasked (query, key) pairs of right-aligned attention: the work
    this input needs."""
    pairs = 0
    for i in range(s):
        row = i + t - s
        hi = row if causal else t - 1
        lo = 0 if window is None else max(0, row - window + 1)
        pairs += max(0, hi - lo + 1)
    return pairs


def _kernel_device_ms(fn, key: str, reps: int = 100) -> float:
    """Device time a call of the kernels whose name holds ``key``:
    torch.profiler's kernel durations over ``reps`` calls of ``fn`` (after
    a warm-up), their mean times the kernels a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0  # key "" takes every kernel of the window
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and key in evt.key:
            us = getattr(evt, "self_device_time_total", None)
            total += (evt.self_cuda_time_total if us is None else us) / 1e3
            count += evt.count
    if total <= 0:
        raise RuntimeError(f"the profiler saw no {key} kernel")
    # the mean kernel times the kernels a call: a kernel the tracer
    # dropped from the window does not pull the time down
    return total / count * max(1, round(count / reps))


def _device_kernels_per_call(fn, reps: int = 20) -> tuple[float, dict]:
    """Device kernels a call of ``fn``: torch.profiler's kernel events over
    ``reps`` calls (after a warm-up), divided by ``reps``; and the count of
    each kernel by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a window where the tracer dropped a kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {evt.key[:60]: evt.count for evt in prof.key_averages()
                if evt.device_type == DeviceType.CUDA}
        if seen and sum(seen.values()) % reps == 0:
            break
    return sum(seen.values()) / reps, seen


def _live_tiles(s: int, t: int, causal: bool, window) -> int:
    """KV tiles of 64 keys the attention kernels visit for one head: for
    each tile of 64 right-aligned queries, the tiles that hold a key of
    the causal / window band of one of its queries."""
    tiles = 0
    for q0 in range(0, s, 64):
        lo, hi = q0 + t - s, min(s, q0 + 64) - 1 + t - s
        k_begin = 0 if window is None else max(0, lo - window + 1)
        k_end = min(t, hi + 1) if causal else t
        tiles += -(-k_end // 64) - k_begin // 64
    return tiles


def _host_time_ms(fn, reps: int = 50) -> float:
    """Host clock around ``reps`` calls that end in a synchronize."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


KINDS = (("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
         ("weighted_ce", ("wce_",)), ("flash", ("flash_",)),
         ("copy/cast", ("copy", "Memcpy", "Memset")),
         ("softmax", ("softmax",)), ("reduce", ("reduce",)),
         ("index/scatter", ("index", "scatter", "gather", "embedding")),
         ("elementwise", ("elementwise",)))


def _kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def _device_profile(fn, top: int = 8) -> dict:
    """torch.profiler around ``fn()`` ending in a synchronize: wall ms (host
    clock, under the profiler), the device's kernel and copy ms, its idle
    share, the ``top`` kernels by device time, and the device ms by kind
    of kernel (GEMMs, copies and casts, elementwise, ...)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}     # the device's own events: kernels and copies
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        dev[evt.key] = dev.get(evt.key, 0.0) + us / 1e3
    busy = sum(dev.values())
    ranked = sorted(dev.items(), key=lambda kv: -kv[1])[:top]
    kinds: dict = {}
    for name, ms in dev.items():
        kinds[_kind_of(name)] = kinds.get(_kind_of(name), 0.0) + ms
    return {"wall_ms": wall_ms,
            "device_ms": busy if dev else "not measured",
            "idle_share": 1 - busy / wall_ms if dev else "not measured",
            "by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top": [[k[:70], v] for k, v in ranked]}


def _ptxas_usage(log: str) -> dict:
    """Registers and spill stores / loads (bytes) of each kernel in an
    ``nvcc -Xptxas=-v`` log, by demangled name without its arguments."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {"regs": None, "spill": [None, None]}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            usage[fn]["spill"] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["regs"] = int(m.group(1))
    names = list(usage)
    filt = os.path.join(os.path.dirname(_cuda_tool("nvcc")), "cu++filt")
    if names and os.path.exists(filt):
        out = subprocess.run([filt, *names], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()
        if len(out) == len(names):
            return {_short_name(pretty): usage[raw]
                    for raw, pretty in zip(names, out)}
    return usage


def _short_name(demangled: str) -> str:
    """``void (anonymous namespace)::f<(int)4>(Args)`` -> ``f<4>``."""
    name = re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|"
                  r"\((int|bool)\)", "", demangled)
    return name[:name.index("(")] if "(" in name else name


def _cuda_tool(name: str) -> str:
    from repro_torch.kernels import _build
    return os.path.join(os.path.dirname(_build._nvcc()), name)


def _sass_count(lib, opcodes) -> dict:
    """How many instructions of each opcode ``cuobjdump -sass`` finds in a
    built library."""
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def _max_rel(a, b) -> float:
    import torch
    denom = torch.clamp(b.abs(), min=1e-30)
    return float(((a - b).abs() / denom).max())


def _dlogits_ratios(d, pd, w, g) -> tuple[float, float]:
    """The backward kernel's dlogits against the plain version's, as
    ratios to their tolerances (each must be <= 1):

    - element by element, |d - pd| <= rtol |pd| + 1e-3 |w g| / V, with
      rtol 2^-7 in bf16 (both round the same float32 value, so they differ
      by at most one bf16 ulp, <= 2^-7 of either) and 1e-5 in float32;
      the atol is a thousandth of a typical entry |w g| / V;
    - each row's sum, which is w g (sum p - 1) = 0: |sum_v d| <= stol |w g|,
      with stol 2^-7 in bf16 (each of the entries, whose magnitudes sum to
      at most 2 |w g|, rounds by at most 2^-8 of itself) and 1e-5 in
      float32.  A kernel that drops small probabilities, or an lse that
      is off, moves the row sum."""
    import torch
    bf16 = d.dtype == torch.bfloat16
    rtol = 2.0 ** -7 if bf16 else 1e-5
    wg = (w.float() * g.float()).abs()[:, None]
    tiny = torch.finfo(torch.float32).tiny
    pdf = pd.float()
    bound = rtol * pdf.abs() + 1e-3 * wg / d.shape[1]
    elem = float(((d.float() - pdf).abs() / bound.clamp(min=tiny)).max())
    rows = d.double().sum(dim=1).abs()
    row = float((rows / (rtol * wg[:, 0].double()).clamp(min=tiny)).max())
    return elem, row


class Smoke:
    def __init__(self) -> None:
        import torch
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failed: list[str] = []
        self.kernels: dict[str, dict] = {}
        self.launches = {name: 0 for name in _counters()}
        self.fashion_fp32 = None       # phase 5's data and accuracy

    def phase(self, num: int, fn) -> None:
        t0 = time.perf_counter()
        try:
            line = fn()
            print(f"phase {num} ok ({time.perf_counter() - t0:.1f} s): "
                  f"{line}", flush=True)
        except Exception as e:  # report and go on: every phase runs
            traceback.print_exc()
            self.failed.append(f"phase {num}")
            print(f"phase {num} FAILED: {type(e).__name__}: {e}", flush=True)

    def require(self, cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(what)

    # ------------------------------------------------------------ counters
    def reset_counts(self) -> None:
        for fn in _counters().values():
            fn.launches = 0

    def read_counts(self, hops: int, where: str, **channel: int) -> None:
        """The main path's launches since reset_counts: one fused
        ignorance update per shipped hop (and no unnormalized one), and the
        wire channel's kernels as ``channel`` names them (0 where not
        named), added to the run's totals."""
        want = {name: 0 for name in _counters()}
        want["ignorance_update"] = hops
        want.update(channel)
        got = {name: fn.launches for name, fn in _counters().items()}
        self.require(got == want,
                     f"{where}: kernel launches {got} != expected {want}")
        for name, count in got.items():
            self.launches[name] += count

    # -------------------------------------------------------------- phases
    def build(self) -> str:
        from repro_torch.kernels import _build
        sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                         if f.endswith(".cu"))
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        _build.build(*sources)
        secs = time.perf_counter() - t0
        usage, hop = {}, {}
        for name in ("flash_attention", "flash_decode"):
            usage.update(_ptxas_usage(_build.LOGS[name]))
        for name in ("ignorance", "quantize"):
            hop.update(_ptxas_usage(_build.LOGS[name]))
        print("flash_ptxas " + json.dumps(usage), flush=True)
        print("hop_ptxas " + json.dumps(hop), flush=True)
        spills = [k for k, u in {**usage, **hop}.items()
                  if u["spill"] != [0, 0]]
        self.require(not spills, f"spilling instantiations: {spills}")
        mma = _sass_count(_build.library_path("flash_attention"),
                          ("HGMMA", "HMMA"))
        self.require(sum(mma.values()) > 0,
                     f"no tensor-core instruction in the flash_attention "
                     f"library's SASS: {mma}")
        return (f"built {sources} with nvcc in {secs:.2f} s; flash "
                f"instantiations {len(usage)}, ignorance and quantize "
                f"{len(hop)}, none spilling; "
                f"flash_attention SASS tensor-core instructions {mma}")

    def kernel_vs_plain(self) -> str:
        torch = self.torch
        from repro_torch.kernels import ignorance as ig
        from repro_torch.kernels import ops
        gen = torch.Generator(device=self.dev).manual_seed(0)
        limit = ig.cluster_limit(self.dev.index or 0)
        # 420, 10500, 42000: the hops of phases 3, 4, 5; then both sides of
        # each boundary of the plan (the cluster limit at 8 and 16 tiles,
        # 2, 3, 4, 5 tiles a CTA under either limit, LARGE_N at 64 tiles)
        ns = [1, 210, 420, 1024, 1000, 4096, 10500, 42000, 2 ** 18,
              2 ** 20 + 3, 2 ** 20]
        for tiles in (8, 16, 24, 32, 48, 64):
            ns += [tiles * ig.BN, tiles * ig.BN + 1]
        rows, plans = [], {}
        for n in ns:
            w = torch.rand(n, generator=gen, device=self.dev) + 0.01
            w /= w.sum()
            r = (torch.rand(n, generator=gen, device=self.dev) > 0.4).float()
            a = torch.tensor(1.7, device=self.dev)
            k_n = ops.ignorance_update(w, r, a)
            p_n = ig.ignorance_update_plain(w, r, a)
            k_w, k_p = ig.ignorance_update_unnormalized(w, r, a)
            p_w, p_p = ig.ignorance_update_unnormalized_plain(w, r, a)
            torch.cuda.synchronize()
            self.require(torch.equal(k_n, p_n),
                         f"n={n}: the update differs from the plain version "
                         f"(max abs {float((k_n - p_n).abs().max())})")
            self.require(torch.equal(k_w, p_w) and torch.equal(k_p, p_p),
                         f"n={n}: the unnormalized mode differs from the "
                         f"plain version in w_new or the partials")
            self.require(torch.equal(ops.ignorance_update(w, r, a), k_n),
                         f"n={n}: two runs differ")
            p = ig.plan(n, limit)
            plans[n] = [p.route, p.cluster, p.ctas, p.tiles_per_cta]
            if n in (10500, 42000, ig.LARGE_N, ig.LARGE_N + 1, 2 ** 18,
                     2 ** 20):
                rows.append({
                    "n": n, "route": p.route,
                    "kernel_ms": _cuda_time_ms(
                        lambda: ops.ignorance_update(w, r, a)),
                    "device_ms": _kernel_device_ms(
                        lambda: ops.ignorance_update(w, r, a), ""),
                    "plain_ms": _cuda_time_ms(
                        lambda: ig.ignorance_update_plain(w, r, a)),
                    "bound_ms": _bound_ms(12 * n + 4, 4 * n)[0]})
            if n == 42000:      # the main path's largest hop (phase 5)
                per_call, seen = _device_kernels_per_call(
                    lambda: ops.ignorance_update(w, r, a))
                self.require(per_call == 1, f"ops.ignorance_update at n = "
                             f"{n}: {per_call} device kernels a call {seen}")
                self._kernel_rows(w, r, a, k_n, p_n, k_w, p_w)
        print(f"ignorance_plans cluster_limit={limit} [route, cluster, "
              f"ctas, tiles_per_cta] " + json.dumps(plans),
              flush=True)
        print("kernel_table " + json.dumps(rows), flush=True)
        floor = self._launch_floor()
        return (f"ignorance n in {ns}: update and unnormalized mode equal to "
                f"the plain versions bit for bit, two runs identical, one "
                f"device kernel a call at n = 42000 (cluster limit {limit}); "
                f"launch floor {floor:.4f} device ms; "
                + self._quantize_vs_plain())

    def _launch_floor(self) -> float:
        """The empty kernel of csrc/ignorance.cu through the same ctypes
        route, plain and as a cluster of 8: call ms and device ms.  Returns
        the plain launch's device ms."""
        from repro_torch.kernels import ignorance as ig
        out = {}
        for cluster in (1, 8):
            def fn():
                ig.launch_floor(self.dev, cluster)
            out[cluster] = {"ms": _cuda_time_ms(fn),
                            "device_ms": _kernel_device_ms(fn,
                                                           "empty_kernel")}
        print("launch_floor " + json.dumps(out), flush=True)
        return out[1]["device_ms"]

    def _quantize_vs_plain(self) -> str:
        """The wire channel's kernels against their plain versions on one
        generator on the card: q, scales and packed bytes exact, xhat equal
        by value, two runs the same bits."""
        torch = self.torch
        from repro_torch.comm.draws import ChannelDraws
        from repro_torch.kernels import ops
        from repro_torch.kernels import quantize as q
        gen = torch.Generator(device=self.dev).manual_seed(1)
        limit = q.cluster_limit(self.dev.index or 0)
        checked, timed, plans = 0, [], {}
        # global tiles on both sides of each boundary of the plan: one CTA
        # (1024), the cluster limit (8 and 16 CTAs), LARGE_TILE
        shapes = [(n,) for n in (1, 420, 1000, 1024, 1025, 10500, 42000,
                                 8192, 8193, 16384, 16385, 2 ** 18,
                                 2 ** 18 + 1, 2 ** 20, 2 ** 20 + 3)]
        # MIMIC's and Fashion's score blocks, global tiles, and the ragged
        # 1020- and 1023-element row tiles
        shapes += [(4500, 2), (18000, 10), (1024, 3), (2048, 10), (2040, 10),
                   (3069, 3)]
        for shape in shapes:
            block = len(shape) == 2
            kern = ops.quantize_dequant_block if block else ops.quantize_dequant
            plain = (q.quantize_dequant_block_plain if block
                     else q.quantize_dequant_plain)
            x = torch.rand(shape, generator=gen, device=self.dev) - 0.3
            for qmax in (127.0, 7.0):
                for u in (torch.rand(shape, generator=gen, device=self.dev),
                          torch.full(shape, 0.5, device=self.dev)):
                    got, want = kern(x, u, qmax), plain(x, u, qmax)
                    torch.cuda.synchronize()
                    self.require(torch.equal(got[1], want[1])
                                 and torch.equal(got[2], want[2]),
                                 f"quantize {shape} qmax={qmax}: q or "
                                 f"scales differ from the plain version")
                    self.require(torch.equal(got[0], want[0]),
                                 f"quantize {shape} qmax={qmax}: xhat "
                                 f"differs from the plain version")
                    again = kern(x, u, qmax)
                    self.require(all(torch.equal(a, b)
                                     for a, b in zip(again, got)),
                                 f"quantize {shape}: two runs differ")
                    checked += 1
            tile = (q.rows_for(*shape) * shape[1] if block
                    else q.tile_for(shape[0]))
            p = q.plan(tile, limit)
            plans[str(shape)] = [p.route, p.cluster, x.numel() // tile
                                 * (1 if p.route == "large" else p.cluster)]
            if shape in ((10500,), (42000,), (2 ** 20,), (2 ** 20 + 3,),
                         (4500, 2), (18000, 10)):
                row = {"shape": list(shape), "route": p.route,
                       "kernel_ms": _cuda_time_ms(lambda: kern(x, u, 127.0)),
                       "device_ms": _kernel_device_ms(
                           lambda: kern(x, u, 127.0), ""),
                       "plain_ms": _cuda_time_ms(lambda: plain(x, u, 127.0)),
                       "bound_ms": _bound_ms(13 * x.numel() + 4,
                                             8 * x.numel())[0]}
                timed.append(row)
            if shape in ((42000,), (18000, 10)):
                per_call, seen = _device_kernels_per_call(
                    lambda: kern(x, u, 127.0))
                self.require(per_call == 1, f"quantize {shape}: {per_call} "
                             f"device kernels a call {seen}")
            if shape == (42000,):
                self._quantize_row("quantize_dequant_tiles", x, u, kern,
                                   plain, "src/repro/kernels/quantize.py:73")
            if shape == (18000, 10):
                self._quantize_row("quantize_dequant_block", x, u, kern,
                                   plain, "src/repro/kernels/quantize.py:178")
        for m in (1, 2, 21001, 42000, 2 ** 20 + 1):
            qv = torch.randint(-8, 8, (m,), generator=gen, device=self.dev,
                               dtype=torch.int8)
            packed = ops.pack_int4(qv)
            torch.cuda.synchronize()
            self.require(torch.equal(packed, q.pack_int4_plain(qv)),
                         f"pack_int4 m={m}: bytes differ from the plain "
                         f"version")
            self.require(torch.equal(ops.pack_int4(qv), packed),
                         f"pack_int4 m={m}: two runs differ")
            back = ops.unpack_int4(packed, m)
            self.require(torch.equal(back, qv)
                         and torch.equal(q.unpack_int4_plain(packed, m), qv),
                         f"unpack_int4 m={m}: the round trip is not exact")
            checked += 1
            if m == 42000:          # a Fashion hop's int4 wire
                self._pack_rows(qv, packed)
        # the channel draws of a Fashion hop and score block, drawn on the
        # host and copied to the card
        key = [0, 0]
        draws = ChannelDraws()
        hop_ms = _host_time_ms(lambda: draws.hop(key, 0, 0).uniform(
            (42000,), self.dev))
        block_ms = _host_time_ms(lambda: draws.serve(key, 1).uniform(
            (18000, 10), self.dev))
        print(f"quantize_plans cluster_limit={limit} [route, cluster, "
              f"ctas] " + json.dumps(plans), flush=True)
        print("quantize_table " + json.dumps(timed), flush=True)
        print(f"draws_ms hop[42000]={hop_ms:.4f} block[18000,10]="
              f"{block_ms:.4f}", flush=True)
        return (f"quantize/pack/unpack: {checked} cases equal to the plain "
                f"versions (q, scales, bytes exact), two runs identical, "
                f"quantize one device kernel a call at (42000,) and "
                f"(18000, 10) (cluster limit {limit}); "
                f"draws to the card {hop_ms:.3f} ms a hop, {block_ms:.3f} ms "
                f"a score block")

    def _quantize_row(self, name, x, u, kern, plain, replaces) -> None:
        got, want = kern(x, u, 127.0), plain(x, u, 127.0)
        nbytes, ops_ = 13 * x.numel() + 4 * got[2].numel(), 8 * x.numel()
        bound, by = _bound_ms(nbytes, ops_)
        self.kernels[name] = {
            "source": "src/repro_torch/csrc/quantize.cu",
            "replaces": replaces,
            "max_abs_err": float((got[0] - want[0]).abs().max()),
            "ms": _cuda_time_ms(lambda: kern(x, u, 127.0)),
            "device_ms": _kernel_device_ms(lambda: kern(x, u, 127.0), ""),
            "plain_ms": _cuda_time_ms(lambda: plain(x, u, 127.0)),
            "bound_ms": bound, "bound_by": by, "library_ms": None}

    def _pack_rows(self, qv, packed) -> None:
        from repro_torch.kernels import ops
        from repro_torch.kernels import quantize as q
        m = qv.numel()
        bound, by = _bound_ms(m + packed.numel(), 4 * m)
        self.kernels["pack_int4"] = {
            "source": "src/repro_torch/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:131",
            "max_abs_err": float((ops.pack_int4(qv).int()
                                  - q.pack_int4_plain(qv).int()).abs().max()),
            "ms": _cuda_time_ms(lambda: ops.pack_int4(qv)),
            "device_ms": _kernel_device_ms(lambda: ops.pack_int4(qv), ""),
            "plain_ms": _cuda_time_ms(lambda: q.pack_int4_plain(qv)),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
        self.kernels["unpack_int4"] = {
            "source": "src/repro_torch/csrc/quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:150",
            "max_abs_err": float((ops.unpack_int4(packed, m).int()
                                  - q.unpack_int4_plain(packed, m).int()
                                  ).abs().max()),
            "ms": _cuda_time_ms(lambda: ops.unpack_int4(packed, m)),
            "device_ms": _kernel_device_ms(lambda: ops.unpack_int4(packed, m),
                                           ""),
            "plain_ms": _cuda_time_ms(
                lambda: q.unpack_int4_plain(packed, m)),
            "bound_ms": bound, "bound_by": by, "library_ms": None}

    def _kernel_rows(self, w, r, a, k_n, p_n, k_w, p_w) -> None:
        from repro_torch.kernels import ignorance as ig
        from repro_torch.kernels import ops
        n, nt = w.shape[0], ig.num_tiles(w.shape[0])
        bound, by = _bound_ms(4 * (3 * n + 1), 4 * n)
        self.kernels["ignorance_update"] = {
            "source": "src/repro_torch/csrc/ignorance.cu",
            "replaces": "src/repro/kernels/ignorance.py:46",
            "max_abs_err": float((k_n - p_n).abs().max()),
            "ms": _cuda_time_ms(lambda: ops.ignorance_update(w, r, a)),
            "device_ms": _kernel_device_ms(
                lambda: ops.ignorance_update(w, r, a), ""),
            "plain_ms": _cuda_time_ms(
                lambda: ig.ignorance_update_plain(w, r, a)),
            "bound_ms": bound, "bound_by": by, "library_ms": None}
        b1, by1 = _bound_ms(4 * (3 * n + 1 + nt), 4 * n)
        self.kernels["ignorance_update_unnormalized"] = {
            "source": "src/repro_torch/csrc/ignorance.cu",
            "replaces": "src/repro/kernels/ignorance.py:46",
            "max_abs_err": float((k_w - p_w).abs().max()),
            "ms": _cuda_time_ms(
                lambda: ig.ignorance_update_unnormalized(w, r, a)),
            "device_ms": _kernel_device_ms(
                lambda: ig.ignorance_update_unnormalized(w, r, a), ""),
            "plain_ms": _cuda_time_ms(
                lambda: ig.ignorance_update_unnormalized_plain(w, r, a)),
            "bound_ms": b1, "bound_by": by1, "library_ms": None}

    def cli_path(self) -> str:
        torch = self.torch
        from repro_torch.launch import session as cli
        out = []
        for transport in ("metered", "meshring"):
            self.reset_counts()
            run = cli.run(cli.parser().parse_args(["--transport", transport]))
            st = run.session.state
            hops = len(st.components)
            self.read_counts(hops, f"cli {transport}")
            out.append(f"{transport}: {run.line}, launches={hops}")
            if transport != "metered":
                continue
            n, m = st.w.shape[0], len(run.session.endpoints)
            kinds = run.transport.log.bits_by_kind()
            train = (m - 1) * 2 * n * 32 + hops * (n + 1) * 32
            self.require(kinds["ignorance"] == hops * n * 32
                         and kinds["model_weight"] == hops * 32
                         and kinds["labels"] + kinds["sample_ids"]
                         == (m - 1) * 2 * n * 32,
                         f"ledger {kinds} != Fig.-4 formula")
            self.require(run.transport.total_bits - kinds["score_block"]
                         == train, "training bits != Fig.-4 formula")
            full_w = st.w.clone()
        ckpt = tempfile.mkdtemp(dir=SMOKE_DIR)
        try:
            self.reset_counts()
            base = ["--ckpt-dir", ckpt]
            paused = cli.run(cli.parser().parse_args(base + ["--stop-after",
                                                             "2"]))
            resumed = cli.run(cli.parser().parse_args(base + ["--resume"]))
            self.read_counts(len(resumed.session.state.components),
                             "cli pause/resume")
            self.require(paused.paused, "the run did not pause")
            self.require(torch.equal(resumed.session.state.w, full_w),
                         "resumed w is not bit-identical")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        return "; ".join(out) + "; Fig.-4 bits exact; resume bit-exact"

    def _split(self, ds, seed=0):
        torch = self.torch
        from repro_torch.data.partition import train_test_split, vertical_split
        tr, te = train_test_split(seed, ds.X.shape[0])
        tr = torch.as_tensor(tr, device=ds.X.device)
        te = torch.as_tensor(te, device=ds.X.device)
        Xs = vertical_split(ds.X, ds.splits)
        return ([x[tr] for x in Xs], ds.classes[tr], [x[te] for x in Xs],
                ds.classes[te])

    def mimic(self) -> str:
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.data.synthetic import mimic_surrogate
        from repro_torch.learners.tree import DecisionTree
        runs = {}
        for device in ("cuda", "cpu"):   # the card, then its plain version
            ds = mimic_surrogate(torch.Generator().manual_seed(0), n=15000,
                                 device=device)
            Xtr, ctr, Xte, cte = self._split(ds)
            proto = E.Protocol(E.SessionConfig(num_classes=2, max_rounds=10),
                               transport=E.MeteredTransport(), device=device)
            eps = E.endpoints_for([DecisionTree(depth=4, num_thresholds=16,
                                                device=device)
                                   for _ in Xtr], Xtr)
            self.reset_counts()
            t0 = time.perf_counter()
            session = proto.start(0, eps, ctr)
            session.run()
            preds = session.fitted().predict(Xte)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if device == "cuda":
                self.read_counts(len(session.state.components), "mimic")
            runs[device] = (session, preds.cpu(), cte.cpu(), secs)
        g, c = runs["cuda"][0].state, runs["cpu"][0].state
        self.require([(x.agent, x.round) for x in g.components]
                     == [(x.agent, x.round) for x in c.components],
                     "components differ between card and CPU")
        ga = torch.tensor([x.alpha for x in g.components])
        ca = torch.tensor([x.alpha for x in c.components])
        torch.testing.assert_close(ga, ca, rtol=1e-5, atol=0)
        w_err = float((g.w.cpu() - c.w).abs().max())
        self.require(w_err <= 1e-6, f"w differs by {w_err} > 1e-6")
        agree = float((runs["cuda"][1] == runs["cpu"][1]).float().mean())
        self.require(agree >= 0.999, f"predictions agree {agree} < 0.999")
        acc = float((runs["cuda"][1] == runs["cuda"][2]).float().mean())
        return (f"mimic n_train=10500 agents=(3,13) depth=4 rounds=10: "
                f"components={len(g.components)} acc={acc:.4f} "
                f"card {runs['cuda'][3]:.2f} s, cpu {runs['cpu'][3]:.2f} s; "
                f"vs cpu: alpha rtol<=1e-5, w err {w_err:.3g}, "
                f"predictions agree {agree:.4f}")

    def fashion(self) -> str:
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.core.protocol import (ASCIIConfig,
                                               fit_single_agent_adaboost)
        from repro_torch.data.synthetic import fashion_surrogate
        from repro_torch.learners.logistic import LogisticRegression
        ds = fashion_surrogate(torch.Generator().manual_seed(0), n=60000,
                               device="cuda")
        Xtr, ctr, Xte, cte = self._split(ds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        learner = LogisticRegression(steps=300, device="cuda")
        proto = E.Protocol(E.SessionConfig(num_classes=10, max_rounds=5),
                           transport=E.MeteredTransport(), device="cuda")
        self.reset_counts()
        t0 = time.perf_counter()
        session = proto.start(0, E.endpoints_for([learner] * 2, Xtr), ctr)
        session.run()
        preds = session.fitted().predict(Xte)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        self.read_counts(len(session.state.components), "fashion")
        cfg = ASCIIConfig(num_classes=10, max_rounds=5)
        single = fit_single_agent_adaboost(0, Xtr[0], ctr, learner, cfg,
                                           device="cuda")
        oracle = fit_single_agent_adaboost(0, torch.cat(Xtr, 1), ctr, learner,
                                           cfg, device="cuda")

        def acc(p):
            return float((p == cte).float().mean())

        a_ascii = acc(preds)
        a_single = acc(single.predict([Xte[0]]))
        a_oracle = acc(oracle.predict([torch.cat(Xte, 1)]))
        st = session.state
        w_sum = float(st.w.sum())
        self.require(abs(w_sum - 1.0) <= 1e-5, f"w sums to {w_sum}")
        self.require(all(math.isfinite(c.alpha) for c in st.components),
                     "non-finite alpha")
        self.require(a_ascii >= a_single,
                     f"ASCII acc {a_ascii} < single-agent acc {a_single}")
        self.fashion_fp32 = (Xtr, ctr, Xte, cte, a_ascii,
                             [c.alpha for c in st.components])
        return (f"fashion n_train=42000 agents=(392,392) logistic steps=300 "
                f"rounds=5: components={len(st.components)} "
                f"acc ascii={a_ascii:.4f} single={a_single:.4f} "
                f"oracle={a_oracle:.4f}; session {secs:.2f} s, "
                f"peak device memory {peak_gib:.3f} GiB, "
                f"ledger {session.transport.total_bits} bits")

    # ------------------------------------------------------- wire channel
    def _channel_session(self, device: str, argv: list, ds_fn, cfg, learner):
        """One session through the CLI's transport for ``argv`` on
        ``device``: (session, transport, predict_distributed classes,
        fitted classes, test classes, seconds)."""
        torch = self.torch
        from repro_torch.core import engine as E
        from repro_torch.launch import session as cli
        args = cli.parser().parse_args(["--device", device, *argv])
        cli.check_args(args)
        transport = cli.make_transport(args)
        Xtr, ctr, Xte, cte = ds_fn(device)
        proto = E.Protocol(cfg, transport=transport, device=device)
        t0 = time.perf_counter()
        session = proto.start(0, E.endpoints_for(
            [learner(device) for _ in Xtr], Xtr), ctr)
        session.run()
        served = session.predict_distributed(Xte)
        fitted = session.fitted().predict(Xte)
        if device == "cuda":
            torch.cuda.synchronize()
        return (session, transport, served.cpu(), fitted.cpu(), cte.cpu(),
                time.perf_counter() - t0)

    @staticmethod
    def _int_codec_counts(transport) -> dict:
        """Expected quantize launches from the ledger: one per int-coded
        hop and one per int-coded score block."""
        from repro_torch.comm.codecs import QuantCodec

        def coded(entry, fixed):
            if "rung" in entry:
                return isinstance(transport.budget.ladder[entry["rung"]],
                                  QuantCodec)
            return isinstance(fixed, QuantCodec)
        log = transport.log.entries
        return {"quantize_dequant_tiles": sum(
                    coded(e, transport.codec) for e in log
                    if e["kind"] == "ignorance"),
                "quantize_dequant_block": sum(
                    coded(e, transport.effective_serve_codec) for e in log
                    if e["kind"] == "score_block")}

    @staticmethod
    def _check_wire_bits(transport, n: int, block: tuple) -> None:
        """Every wire-priced entry equals its codec's wire_bits formula."""
        for e in transport.log.entries:
            if e["kind"] not in ("ignorance", "score_block"):
                continue
            shape = n if e["kind"] == "ignorance" else block
            if "rung" in e:
                codec = transport.budget.ladder[e["rung"]]
            elif e["kind"] == "ignorance":
                codec = transport.codec
            else:
                codec = transport.effective_serve_codec
            want = 32 * (n if e["kind"] == "ignorance" else block[0] *
                         block[1]) if codec is None else codec.wire_bits(shape)
            if e["bits"] != want:
                raise AssertionError(f"ledger entry {e} != wire_bits {want}")

    def mimic_channel(self) -> str:
        torch = self.torch
        from repro_torch.comm.budget import BudgetSpec
        from repro_torch.core import engine as E
        from repro_torch.data.synthetic import mimic_surrogate
        from repro_torch.learners.tree import DecisionTree

        def data(device):
            ds = mimic_surrogate(torch.Generator().manual_seed(0), n=15000,
                                 device=device)
            return self._split(ds)

        n, m, n_te = 10500, 2, 4500
        costs = BudgetSpec().hop_costs(n)
        # setup, then one hop at each rung fp32, fp16, int8, int4, then
        # skips: the session ends exhausted
        budget_bits = (m - 1) * 2 * n * 32 + sum(costs) + 100
        configs = [["--codec", "int8"],
                   ["--codec", "int4", "--serve-codec", "int8"],
                   ["--codec", "topk"],
                   ["--dp-epsilon", "1.0", "--accountant", "rdp"],
                   ["--byte-budget", str(-(-budget_bits // 8))]]
        cfg = E.SessionConfig(num_classes=2, max_rounds=10)
        out = []
        for argv in configs:
            runs = {}
            for device in ("cuda", "cpu"):
                if device == "cuda":
                    self.reset_counts()
                runs[device] = self._channel_session(
                    device, argv, data, cfg,
                    lambda dev: DecisionTree(depth=4, num_thresholds=16,
                                             device=dev))
                if device == "cuda":
                    t = runs[device][1]
                    self.read_counts(
                        sum(e["kind"] == "ignorance" for e in t.log.entries),
                        f"mimic {' '.join(argv)}",
                        **self._int_codec_counts(t))
            (gs, gt, gserve, gfit, cte, gsec), (cs, ct, cserve, cfit, _,
                                                csec) = (runs["cuda"],
                                                         runs["cpu"])
            name = " ".join(argv)
            self.require(gt.log.entries == ct.log.entries,
                         f"{name}: card and CPU ledgers differ")
            self._check_wire_bits(gt, n, (n_te, 2))
            self.require((gs.state.round, gs.state.stopped)
                         == (cs.state.round, cs.state.stopped),
                         f"{name}: stop rounds differ")
            self.require([(c.agent, c.round) for c in gs.state.components]
                         == [(c.agent, c.round) for c in cs.state.components],
                         f"{name}: components differ")
            torch.testing.assert_close(
                torch.tensor([c.alpha for c in gs.state.components]),
                torch.tensor([c.alpha for c in cs.state.components]),
                rtol=1e-5, atol=0)
            self.require(torch.equal(gserve, cserve)
                         and torch.equal(gfit, cfit),
                         f"{name}: predictions differ between card and CPU")
            if gt.accountant is not None:
                self.require(gt.accountant.releases == ct.accountant.releases,
                             f"{name}: DP releases differ")
            rungs = ""
            if hasattr(gt, "budget"):
                self.require((gt.skipped, gt.exhausted)
                             == (ct.skipped, ct.exhausted) and gt.exhausted,
                             f"{name}: budget skips/exhaustion differ or the "
                             f"session did not end exhausted")
                used = sorted({e["rung"] for e in gt.log.entries
                               if "rung" in e})
                self.require(len(used) >= 3, f"{name}: rungs {used} < 3")
                rungs = f",rungs={used},skipped={len(gt.skipped)}"
            same_w = torch.equal(gs.state.w.cpu(), cs.state.w)
            acc = float((gserve == cte).float().mean())
            kinds = gt.log.bits_by_kind()
            out.append(f"[{name}] hops={len(gs.state.components)} "
                       f"ignorance_bits={kinds.get('ignorance', 0)} "
                       f"score_block_bits={kinds.get('score_block', 0)}"
                       f"{rungs} serve_acc={acc:.4f} w_bit_equal={same_w} "
                       f"card {gsec:.2f} s cpu {csec:.2f} s")
        return ("mimic through the wire channel, card = cpu (ledgers, "
                "wire_bits, stops, predictions exact; alphas rtol 1e-5): "
                + "; ".join(out))

    def fashion_channel(self) -> str:
        torch = self.torch
        from repro_torch.comm.codecs import QuantCodec
        from repro_torch.core import engine as E
        from repro_torch.learners.logistic import LogisticRegression
        self.require(self.fashion_fp32 is not None,
                     "phase 5's fp32 session did not run")
        Xtr, ctr, Xte, cte, a_fp32, alphas_fp32 = self.fashion_fp32
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.reset_counts()
        session, t, served, fitted, cte, secs = self._channel_session(
            "cuda", ["--codec", "int8", "--serve-codec", "int4"],
            lambda device: (Xtr, ctr, Xte, cte),
            E.SessionConfig(num_classes=10, max_rounds=5),
            lambda dev: LogisticRegression(steps=300, device=dev))
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        # the int wires of a real hop's w: encode (quantize, and pack for
        # int4) then decode (unpack) equals the fused roundtrip, and every
        # element lies within one quantization step of its input
        w = session.state.w
        draws = session.draws.hop(session.state.key, 0, 0)
        for bits in (4, 8):
            codec = QuantCodec(bits=bits)
            wire, _ = codec.encode(w, draws)
            decoded = codec.decode(wire)
            fused, _ = codec.roundtrip(w, draws)
            torch.cuda.synchronize()
            self.require(torch.equal(decoded, fused),
                         f"int{bits} encode -> decode != roundtrip on a "
                         f"hop's w")
            step = float(wire[1].max())
            self.require(float((decoded - w).abs().max()) <= step,
                         f"int{bits}: an element is more than one step "
                         f"({step}) from its input")
        counts = self._int_codec_counts(t)
        counts["quantize_dequant_tiles"] += 4       # encode and roundtrip x2
        self.read_counts(sum(e["kind"] == "ignorance" for e in t.log.entries),
                         "fashion int8", pack_int4=1, unpack_int4=1,
                         **counts)
        self._check_wire_bits(t, Xtr[0].shape[0], tuple(served.shape) + (10,))
        alphas = [c.alpha for c in session.state.components]
        self.require(all(math.isfinite(a) for a in alphas),
                     "non-finite alpha")
        # the first fit sees the uniform w, before any hop crossed the wire
        self.require(alphas[0] == alphas_fp32[0],
                     f"first alpha {alphas[0]} != the fp32 session's "
                     f"{alphas_fp32[0]}")
        a_int8 = float((fitted == cte).float().mean())
        a_serve = float((served == cte).float().mean())
        # No accuracy bound against fp32: at this width the int8 global tile
        # zeroes most easy samples' weights, the next fits score r-bar = 1 on
        # what is left, and their capped alphas (20) dominate the vote.  The
        # reference does the same (tests/test_torch_comm_session.py::
        # test_fashion_int8_session_tracks_reference_on_card holds the
        # port's accuracy to the reference's on the card).
        kinds = t.log.bits_by_kind()
        return (f"fashion n_train=42000 agents=(392,392) rounds=5 --codec int8 "
                f"--serve-codec int4: acc ascii={a_int8:.4f} (fp32 phase 5 "
                f"{a_fp32:.4f}), served through int4 "
                f"{a_serve:.4f}; alphas int8 {[round(a, 3) for a in alphas]} "
                f"fp32 {[round(a, 3) for a in alphas_fp32]}; "
                f"ignorance_bits={kinds['ignorance']} score_block_bits="
                f"{kinds['score_block']} (= wire_bits); session {secs:.2f} s, "
                f"peak device memory {peak_gib:.3f} GiB; int4/int8 "
                f"encode->decode of a hop's w = roundtrip, within one step "
                f"(pack/unpack at n={w.numel()})")

    # ------------------------------------------------------- model zoo
    # The dense models' attention: (model, batch, H, KV, D, window);
    # danube's window of 4096 is cut to 128 so that it bites at S 512.
    FLASH_SHAPES = (("qwen3-0.6b", 4, 16, 8, 128, None),
                    ("h2o-danube-3-4b", 2, 32, 8, 120, 128),
                    ("gemma-7b", 2, 16, 16, 256, None))

    def flash_vs_plain(self) -> str:
        torch = self.torch
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        gen = torch.Generator(device=self.dev).manual_seed(2)
        tols = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
        worst, timed = {}, []

        def randn(*shape, dtype):
            return torch.randn(*shape, generator=gen, device=self.dev).to(
                dtype)

        def check(what, key, got, again, want, vmax, tol):
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            self.require(err <= tol * vmax,
                         f"{what}: max err {err} > {tol} * {vmax}")
            self.require(torch.equal(got, again),
                         f"{what}: two runs differ")
            worst[key] = max(worst.get(key, 0.0), err / vmax)

        for model, b, h, kv, d, win in self.FLASH_SHAPES:
            cases = [(512, 512, win), (500, 500, win), (500, 512, win)]
            if win is None:
                cases.append((512, 512, 128))
            for dtype, tol in tols.items():
                for s, t, window in cases:
                    # the model's layout: [B, S, H, D] seen as [B, H, S, D]
                    q = randn(b, s, h, d, dtype=dtype).transpose(1, 2)
                    k = randn(b, t, kv, d, dtype=dtype).transpose(1, 2)
                    v = randn(b, t, kv, d, dtype=dtype).transpose(1, 2)
                    got = fa.flash_attention(q, k, v, window=window)
                    again = fa.flash_attention(q, k, v, window=window)
                    want = fa.flash_attention_plain(q, k, v, window=window)
                    check(f"flash_attention {model} {dtype} S={s} T={t} "
                          f"window={window}",
                          f"attention {model} {str(dtype)[6:]}", got, again,
                          want, float(v.float().abs().max()), tol)
                    if dtype == torch.bfloat16 and s == t == 512 \
                            and window == win:
                        timed.append(("attention", model, (q, k, v),
                                      window, got, want))
            for dtype, tol in tols.items():
                q = randn(b, h, d, dtype=dtype)
                for quant in (False, True):
                    if quant:
                        k, v = (torch.randint(-127, 128, (b, 576, kv, d),
                                              generator=gen, device=self.dev,
                                              dtype=torch.int8)
                                for _ in range(2))
                        ks, vs = (torch.rand(b, 576, kv, generator=gen,
                                             device=self.dev) * 0.05
                                  for _ in range(2))
                        scales = dict(k_scale=ks.transpose(1, 2),
                                      v_scale=vs.transpose(1, 2))
                        vmax = float((v.float() * vs[..., None]).abs().max())
                    else:
                        k = randn(b, 576, kv, d, dtype=dtype)
                        v = randn(b, 576, kv, d, dtype=dtype)
                        scales, vmax = {}, float(v.float().abs().max())
                    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
                    for pos in (0, 511, 575):
                        for window in (None, 128):
                            got, again = (fd.flash_decode(
                                q, kt, vt, pos, window=window, **scales)
                                for _ in range(2))
                            want = fd.flash_decode_plain(
                                q, kt, vt, pos, window=window, **scales)
                            check(f"flash_decode {model} {dtype} quant="
                                  f"{quant} pos={pos} window={window}",
                                  f"decode {model} {str(dtype)[6:]}"
                                  f"{' int8' if quant else ''}", got, again,
                                  want, vmax, tol)
                    if dtype == torch.bfloat16 and (
                            model == "qwen3-0.6b" or not quant):
                        timed.append(("decode", model, (q, kt, vt), scales,
                                      got, want))
        # the decode grid at the serve shape's last step (pos 575)
        b, h, kv, d = self.FLASH_SHAPES[0][1:5]
        sms = fd.sm_count(torch.cuda.current_device())
        lo, hi = fd.valid_range(575, 576, None)
        gt = fd.heads_per_block(h // kv)
        n_split, chunk = fd.split_plan(lo, hi, b * h // gt, sms,
                                       fd.rows_per_pass(torch.bfloat16, d))
        blocks = b * h // gt * n_split
        self.require(gt == h // kv and blocks >= 2 * sms,
                     f"flash_decode grid {blocks} blocks ({gt} heads a "
                     f"block) on {sms} SMs")
        # call times first, then the profiler's device times (so that no
        # call time is taken after a profiler session)
        rows = [self._flash_row(*row) for row in timed]
        table = [row for row, _ in rows]
        for (row, lib_fn), (kind, _, tensors, extra, _, _) in zip(rows,
                                                                  timed):
            key = "flash_attention" if kind == "attention" else "flash_decode"
            fn = self._flash_call(kind, tensors, extra)
            row["device_ms"] = _kernel_device_ms(lambda: fn(*tensors), key)
            row["library_device_ms"] = _kernel_device_ms(lib_fn, "")
            copies = [tuple(x.clone() for x in tensors)
                      for _ in range(max(2, -(-120 * 2 ** 20 // sum(
                          x.numel() * x.element_size() for x in tensors))))]
            turn = iter(range(10 ** 9))
            row["device_ms_cold"] = _kernel_device_ms(
                lambda: fn(*copies[next(turn) % len(copies)]), key)
        for row in table:
            if row["model"] == "qwen3-0.6b" and row.get("cache") != "int8":
                name = ("flash_attention" if "T" in row else "flash_decode")
                self.kernels[name] = {k: row[k] for k in (
                    "source", "replaces", "max_abs_err", "ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
        for row in table:
            for k in ("source", "replaces"):
                row.pop(k)
        print("flash_table " + json.dumps(table), flush=True)
        print("flash_scaling " + json.dumps(self._flash_scaling()),
              flush=True)
        return ("flash kernels = plain versions, two runs the same bits, at "
                "qwen3-0.6b's, h2o-danube-3-4b's and gemma-7b's shapes; max "
                "err / max|v|: " + ", ".join(f"{k} {v:.3g}"
                                             for k, v in worst.items())
                + f" (tolerance 2e-5 f32, 2^-7 bf16); decode grid {blocks} "
                f"blocks on {sms} SMs ({n_split} splits of {chunk} "
                f"positions, {gt} query heads a block)")

    def _flash_scaling(self) -> list:
        """bf16 flash_attention at qwen3-0.6b's heads (H 16, KV 8, D 128)
        over more batches, lengths and masks, each against its plain
        version (2^-7 max|v|): its device time and SDPA's beside the
        kernel's blocks (B * H * ceil(S / 64)) and live KV tiles of 64,
        which is how its time splits into a cost a block and a cost a
        tile."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import flash_attention as fa
        gen = torch.Generator(device=self.dev).manual_seed(3)
        rows = []
        for b, s, causal, window in (
                (4, 512, True, None), (8, 512, True, None),
                (16, 512, True, None), (4, 1024, True, None),
                (4, 2048, True, None), (4, 512, False, None),
                (4, 512, True, 64), (1, 512, True, None)):
            q, k, v = (torch.randn(b, s, h, 128, generator=gen,
                                   device=self.dev).to(torch.bfloat16)
                       .transpose(1, 2) for h in (16, 8, 8))
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window)
            err = float((got.float() - want.float()).abs().max())
            self.require(err <= 2 ** -7 * float(v.float().abs().max()),
                         f"flash_attention B={b} S={s} causal={causal} "
                         f"window={window}: max err {err}")
            row = {"B": b, "S": s, "causal": causal, "window": window,
                   "blocks": b * 16 * -(-s // 64),
                   "kv_tiles": b * 16 * _live_tiles(s, s, causal, window),
                   "device_ms": _kernel_device_ms(lambda: fa.flash_attention(
                       q, k, v, causal=causal, window=window),
                       "flash_attention")}
            if window is None:
                row["library_device_ms"] = _kernel_device_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, is_causal=causal, enable_gqa=True), "")
            rows.append(row)
        return rows

    def _flash_call(self, kind, tensors, extra):
        """The kernel's wrapper with its options bound: f(q, k, v[, k_scale,
        v_scale]); decode at the serve path's last step (pos 575)."""
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        if kind == "attention":
            return lambda q, k, v: fa.flash_attention(q, k, v, window=extra)
        if extra:
            return lambda q, k, v: fd.flash_decode(q, k, v, 575, **extra)
        return lambda q, k, v: fd.flash_decode(q, k, v, 575)

    def _flash_row(self, kind, model, tensors, extra, got, want):
        """One bf16 row of flash_table: call ms (CUDA events around
        back-to-back calls), the plain version's, the library call's
        (F.scaled_dot_product_attention, a boolean mask where a window or a
        cache position needs one) and the bound of this input; and the
        library call, for its device time."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import flash_decode as fd
        q, k, v = tensors
        fn = self._flash_call(kind, tensors, extra)
        ms = _cuda_time_ms(lambda: fn(q, k, v), reps=100)
        if kind == "attention":
            b, h, s, d = q.shape
            t, window = k.shape[2], extra
            plain_ms = _cuda_time_ms(lambda: fa.flash_attention_plain(
                q, k, v, window=window), reps=10, warmup=2)
            if window is None:
                def lib_fn():
                    return F.scaled_dot_product_attention(
                        q, k, v, is_causal=True, enable_gqa=True)
            else:
                rows = torch.arange(s, device=self.dev)[:, None] + (t - s)
                cols = torch.arange(t, device=self.dev)[None]
                mask = (cols <= rows) & (cols > rows - window)

                def lib_fn():
                    return F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, enable_gqa=True)
            nbytes = q.element_size() * (2 * q.numel() + k.numel()
                                         + v.numel())
            ops_ = 4 * b * h * d * _attention_pairs(s, t, True, window)
            row = {"model": model, "S": s, "T": t, "window": window,
                   "source":
                   "src/repro_torch/csrc/flash_attention.cu", "replaces":
                   "src/repro/kernels/flash_attention.py:106"}
        else:
            b, h, d = q.shape
            kv, s = k.shape[1], k.shape[2]
            pos, scales = s - 1, extra
            got = fn(q, k, v)
            want = fd.flash_decode_plain(q, k, v, pos, **scales)
            plain_ms = _cuda_time_ms(lambda: fd.flash_decode_plain(
                q, k, v, pos, **scales), reps=50)
            if scales:  # SDPA on the dequantized copy (made outside timing)
                kl = (k.float() * scales["k_scale"][..., None]).to(q.dtype)
                vl = (v.float() * scales["v_scale"][..., None]).to(q.dtype)
            else:
                kl, vl = k, v
            mask = (torch.arange(s, device=self.dev) <= pos)[None, None,
                                                              None]
            q4 = q[:, :, None]

            def lib_fn():
                return F.scaled_dot_product_attention(
                    q4, kl, vl, attn_mask=mask, enable_gqa=True)
            valid = pos + 1
            cache_bytes = 2 * b * kv * valid * d * k.element_size()
            if scales:
                cache_bytes += 2 * b * kv * valid * 4
            nbytes = 2 * q.numel() * q.element_size() + cache_bytes
            ops_ = 4 * b * h * valid * d
            row = {"model": model, "S": s, "pos": pos,
                   "cache": "int8" if scales else "bf16", "source":
                   "src/repro_torch/csrc/flash_decode.cu", "replaces":
                   "src/repro/kernels/flash_decode.py:96"}
        lib_ms = _cuda_time_ms(lib_fn, reps=100)
        bound, by = _bound_ms(nbytes, ops_, BF16_OPS_PER_S)
        row.update({"dtype": "bf16", "max_abs_err": float(
            (got.float() - want.float()).abs().max()), "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": by})
        return row, lib_fn

    def serve(self) -> str:
        torch = self.torch
        from repro_torch.launch import serve as cli
        from repro_torch.models import api
        batch, prompt_len, gen = 4, 512, 64
        common = ["--arch", "qwen3-0.6b", "--no-reduced", "--use_flash",
                  "--batch", str(batch), "--prompt_len", str(prompt_len),
                  "--device", "cuda", "--seed", "0"]
        argv = common + ["--gen", str(gen)]
        # warm-up at the same prompt (libraries, cuBLAS plans); not counted
        warm = cli.run(cli.parser().parse_args(common + ["--gen", "2"]))
        params, layers, steps = warm.params, warm.cfg.num_layers, gen - 1
        self.require(warm.cfg.d_model == 1024 and layers == 28
                     and warm.cfg.dtype == "bfloat16",
                     f"not qwen3-0.6b at full width: {warm.cfg}")
        out, runs = [], {}
        for name, extra in (("fp", []), ("kv_quant", ["--kv_quant"])):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.reset_counts()
            run = cli.run(cli.parser().parse_args(argv + extra), params)
            self.read_counts(0, f"serve {name}", flash_attention=layers,
                             flash_decode=layers * steps)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            toks = run.tokens
            self.require(tuple(toks.shape) == (batch, gen)
                         and int(toks.min()) >= 0
                         and int(toks.max()) < run.cfg.vocab_size,
                         f"serve {name}: tokens {tuple(toks.shape)} out of "
                         f"range")
            runs[name] = run
            out.append(f"[{name}] prefill {run.prefill_s * 1e3:.2f} ms, "
                       f"decode {run.decode_s * 1e3 / steps:.3f} ms/step, "
                       f"{steps * batch / run.decode_s:.1f} tok/s, peak "
                       f"device memory {peak_gib:.3f} GiB; "
                       f"{run.lines[0]}; {run.lines[1]}")
        profile = {name: self._profile(api, runs["fp"], quant)
                   for name, quant in (("fp", False), ("kv_quant", True))}
        print("serve_profile " + json.dumps(profile), flush=True)
        errs = {name: self._teacher_forced(api, runs["fp"], quant)
                for name, quant in (("fp", False), ("kv_quant", True))}
        return ("qwen3-0.6b full width (28 layers, bf16, 596049920 params) "
                f"batch {batch} prompt {prompt_len} gen {gen} --use_flash: "
                + "; ".join(out) + "; teacher-forced, worst max|dlogits| / "
                "max|logits| against the float32 einsum path (use_flash="
                "False): " + "; ".join(
                    f"[{name}] " + ", ".join(f"{k} {v:.4g}"
                                             for k, v in e.items())
                    for name, e in errs.items()))

    def _profile(self, api, run, quant: bool, steps: int = 8) -> dict:
        """torch.profiler over one prefill and ``steps`` decode steps of the
        flash path on one run's weights and tokens: wall ms (host clock,
        under the profiler), the device's kernel and copy ms, its idle
        share, and the top kernels by device time, for each window."""
        cfg, params = run.cfg, run.params
        s = run.prompt.shape[1]
        out, caches = {}, None

        def prefill():
            nonlocal caches
            _, c = api.make_prefill_step(cfg)(params, {"tokens": run.prompt})
            c = api.pad_prefill_cache(c, cfg, s + run.tokens.shape[1])
            caches = api.quantize_cache(c, cfg) if quant else c

        def decode():
            for i in range(steps):
                api.decode_step(params, caches, run.tokens[:, i:i + 1], s + i,
                                cfg)

        for window, fn in (("prefill", prefill), (f"decode x{steps}", decode)):
            out[window] = _device_profile(fn)
        return out

    def _teacher_forced(self, api, run, quant: bool) -> dict:
        """One run's weights, prompt and continuation through four paths:
        the flash kernels and the einsum attention (use_flash=False), each
        in bf16 and with the weights in float32.  Prefill, then every
        decode step fed the same token.  The float32 einsum path is the
        reference: the float32 flash path must be within 1e-4 max|logits|
        of it (1e-3 with the int8 cache, whose values at a rounding
        boundary follow ulps of K), and the bf16 flash path no further
        from it than 1.25 times the bf16 einsum path.  Returns the worst
        max|dlogits| / max|logits| of each comparison."""
        torch = self.torch
        batch, s = run.prompt.shape
        s_cache = s + run.tokens.shape[1]

        def up(tree):
            return {k: up(v) if isinstance(v, dict) else v.float()
                    for k, v in tree.items()}

        cfg, p32 = run.cfg, up(run.params)
        paths = {"flash_bf16": (cfg, run.params),
                 "einsum_bf16": (cfg.with_overrides(use_flash=False),
                                 run.params),
                 "flash_f32": (cfg.with_overrides(dtype="float32"), p32),
                 "einsum_f32": (cfg.with_overrides(use_flash=False,
                                                   dtype="float32"), p32)}
        f32_bound = 1e-3 if quant else 1e-4
        worst = {"flash_f32": 0.0, "flash_bf16": 0.0, "einsum_bf16": 0.0,
                 "flash_vs_einsum_bf16": 0.0}

        def rel(a, b):
            return float((a.float() - b.float()).abs().max()
                         / b.float().abs().max())

        def check(out, where):
            ref = out["einsum_f32"]
            err = {n: rel(out[n], ref)
                   for n in ("flash_f32", "flash_bf16", "einsum_bf16")}
            err["flash_vs_einsum_bf16"] = rel(out["flash_bf16"],
                                              out["einsum_bf16"])
            tag = f"teacher-forced {where} quant={quant}"
            self.require(all(math.isfinite(e) for e in err.values()),
                         f"{tag}: non-finite logits {err}")
            self.require(err["flash_f32"] <= f32_bound,
                         f"{tag}: float32 flash path {err['flash_f32']} > "
                         f"{f32_bound} max|logits| from the einsum path")
            self.require(err["flash_bf16"] <= 1.25 * err["einsum_bf16"],
                         f"{tag}: bf16 flash path {err['flash_bf16']} from "
                         f"float32 > 1.25 x the bf16 einsum path's "
                         f"{err['einsum_bf16']}")
            for n, e in err.items():
                worst[n] = max(worst[n], e)

        caches, out = {}, {}
        for name, (c, p) in paths.items():
            lg, cache, _ = api.forward(p, {"tokens": run.prompt}, c)
            cache = api.pad_prefill_cache(cache, c, s_cache)
            caches[name] = api.quantize_cache(cache, c) if quant else cache
            out[name] = lg
        check(out, "prefill")
        del out
        for i in range(run.tokens.shape[1] - 1):
            tok = run.tokens[:, i:i + 1]
            check({name: api.decode_step(p, caches[name], tok, s + i, c)[0]
                   for name, (c, p) in paths.items()}, f"step {i}")
        return worst

    # ------------------------------------------------------ weighted CE
    def ce_vs_plain(self) -> str:
        torch = self.torch
        from repro_torch.configs.registry import ARCHS
        from repro_torch.data.synthetic import token_stream
        from repro_torch.kernels import weighted_ce as wce
        from repro_torch.launch.train import PRESETS
        from repro_torch.models import api
        gen = torch.Generator(device=self.dev).manual_seed(3)
        host = torch.Generator().manual_seed(3)
        cases = []
        # the training path's rows: [B, S, V] logits as the loss hands them
        for name, cfg in (("qwen3-0.6b", ARCHS["qwen3-0.6b"]),
                          ("100m", PRESETS["100m"])):
            b, s, v = 8, 256, cfg.vocab_size
            dtype = getattr(torch, cfg.dtype)
            logits = (torch.randn(b, s, v, generator=gen, device=self.dev)
                      * 2).to(dtype)
            batch = {"tokens": token_stream(host, vocab_size=v, batch=b,
                                            seq_len=s, device=self.dev),
                     "sample_weight": torch.rand(b, generator=gen,
                                                 device=self.dev) + 0.5}
            cases.append((name, *api.next_token_rows(logits, batch, cfg)))
        for t, v in ((2040, 1000), (7, 3)):
            for dtype in (torch.float32, torch.bfloat16):
                x = (torch.randn(t, v, generator=gen, device=self.dev)
                     * 3).to(dtype)
                lab = torch.randint(0, v, (t,), generator=gen,
                                    device=self.dev, dtype=torch.int32)
                w = torch.rand(t, generator=gen, device=self.dev)
                w[::5] = 0.0
                cases.append((f"{t}x{v} {str(dtype)[6:]}", x, lab, w))
        worst, table = {}, []
        for name, x, lab, w in cases:
            g = torch.full_like(w, 1.0 / float(w.sum()))  # the loss's g
            loss, lse = wce.weighted_ce_fwd(x, lab, w)
            ploss, plse = wce.weighted_ce_fwd_plain(x, lab, w)
            d = wce.weighted_ce_bwd(x, lab, w, lse, g)
            pd = wce.weighted_ce_bwd_plain(x, lab, w, lse, g)
            torch.cuda.synchronize()
            rel = max(float(((a - p).abs() / (1e-5 * p.abs() + 1e-6)).max())
                      for a, p in ((loss, ploss), (lse, plse)))
            self.require(rel <= 1.0, f"weighted_ce_fwd {name}: loss or lse "
                         f"beyond rtol 1e-5 (+ atol 1e-6) of the plain "
                         f"version (ratio {rel})")
            elem, row = _dlogits_ratios(d, pd, w, g)
            self.require(elem <= 1.0 and row <= 1.0,
                         f"weighted_ce_bwd {name}: dlogits beyond the plain "
                         f"version's by {elem} of the element tolerance, "
                         f"row sums {row} of theirs")
            again = wce.weighted_ce_fwd(x, lab, w)
            self.require(torch.equal(again[0], loss)
                         and torch.equal(again[1], lse)
                         and torch.equal(wce.weighted_ce_bwd(x, lab, w, lse,
                                                             g), d),
                         f"weighted_ce {name}: two runs differ")
            worst[name] = (float(((loss - ploss).abs()
                                  / ploss.abs().clamp(min=1e-30)).max()),
                           elem, row)
            if name in ("qwen3-0.6b", "100m"):
                table.append(self._ce_row(name, x, lab, w, g, loss, ploss,
                                          d, pd))
        print("ce_table " + json.dumps(table), flush=True)
        return ("weighted_ce kernels = plain versions, two runs identical; "
                "max rel err loss, dlogits element and row-sum errors as "
                "shares of their tolerances: "
                + ", ".join(f"{k} {a:.3g} {b:.3g} {c:.3g}"
                            for k, (a, b, c) in worst.items())
                + " (loss rtol 1e-5; dlogits rtol 2^-7 bf16, 1e-5 f32, "
                "per element, row sums 0 within the same share of |w g|)")

    def _ce_row(self, name, x, lab, w, g, loss, ploss, d, pd) -> dict:
        """Times at a training shape: both kernels, their plain versions,
        F.cross_entropy (reduction='none') forward, its backward through
        autograd (the graph kept), and both together; the qwen3 row is the
        kernels' JSON rows."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import weighted_ce as wce
        t, v = x.shape
        lse = wce.weighted_ce_fwd(x, lab, w)[1]
        fwd_ms = _cuda_time_ms(lambda: wce.weighted_ce_fwd(x, lab, w),
                               reps=50)
        bwd_ms = _cuda_time_ms(lambda: wce.weighted_ce_bwd(x, lab, w, lse, g),
                               reps=50)
        pfwd_ms = _cuda_time_ms(lambda: wce.weighted_ce_fwd_plain(x, lab, w),
                                reps=10, warmup=2)
        pbwd_ms = _cuda_time_ms(
            lambda: wce.weighted_ce_bwd_plain(x, lab, w, lse, g), reps=10,
            warmup=2)
        lab64 = lab.long()
        xg = x.detach().requires_grad_(True)
        lib_fwd = _cuda_time_ms(lambda: F.cross_entropy(
            xg.detach(), lab64, reduction="none"), reps=50)
        nll = F.cross_entropy(xg, lab64, reduction="none")
        lib_bwd = _cuda_time_ms(lambda: torch.autograd.grad(
            nll, xg, g, retain_graph=True), reps=50)
        del nll

        def both():
            torch.autograd.grad(F.cross_entropy(xg, lab64, reduction="none"),
                                xg, g)
        lib_both = _cuda_time_ms(both, reps=50)
        esize = x.element_size()
        b_fwd, by_fwd = _bound_ms(t * v * esize + 16 * t, 4 * t * v)
        b_bwd, by_bwd = _bound_ms(2 * t * v * esize + 16 * t, 4 * t * v)
        row = {"shape": name, "T": t, "V": v, "dtype": str(x.dtype)[6:],
               "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "plain_fwd_ms": pfwd_ms,
               "plain_bwd_ms": pbwd_ms, "cross_entropy_fwd_ms": lib_fwd,
               "cross_entropy_bwd_ms": lib_bwd,
               "cross_entropy_fwd_bwd_ms": lib_both, "fwd_bound_ms": b_fwd,
               "bwd_bound_ms": b_bwd, "bound_by": by_fwd}
        if name == "qwen3-0.6b":     # the training path's main shape
            self.kernels["weighted_ce_fwd"] = {
                "source": "src/repro_torch/csrc/weighted_ce.cu",
                "replaces": "src/repro/kernels/weighted_ce.py:68",
                "max_abs_err": float((loss - ploss).abs().max()),
                "ms": fwd_ms, "device_ms": _kernel_device_ms(
                    lambda: wce.weighted_ce_fwd(x, lab, w), "wce_fwd", 50),
                "plain_ms": pfwd_ms, "bound_ms": b_fwd,
                "bound_by": by_fwd, "library_ms": lib_fwd}
            self.kernels["weighted_ce_bwd"] = {
                "source": "src/repro_torch/csrc/weighted_ce.cu",
                "replaces": "src/repro/kernels/weighted_ce.py:113",
                "max_abs_err": float((d.float() - pd.float()).abs().max()),
                "ms": bwd_ms, "device_ms": _kernel_device_ms(
                    lambda: wce.weighted_ce_bwd(x, lab, w, lse, g), "wce_bwd",
                    50),
                "plain_ms": pbwd_ms, "bound_ms": b_bwd,
                "bound_by": by_bwd, "library_ms": lib_bwd}
        return row

    # ------------------------------------------------------------ train
    def train(self) -> str:
        torch = self.torch
        from repro_torch.launch import train as cli
        from repro_torch.models import api
        steps = 20
        torch.cuda.synchronize()
        self.reset_counts()
        run = cli.run(cli.parser().parse_args(
            ["--arch", "qwen3-0.6b", "--steps", str(steps), "--device",
             "cuda", "--seed", "0"]))
        self.read_counts(0, "train qwen3-0.6b", weighted_ce_fwd=steps,
                         weighted_ce_bwd=steps)
        cfg = run.cfg
        n_params = api.count_params(run.params)
        self.require(cfg.num_layers == 28 and cfg.d_model == 1024
                     and cfg.dtype == "bfloat16" and n_params == 596049920,
                     f"not qwen3-0.6b at full width: {cfg}, {n_params}")
        losses = [h["loss"] for h in run.history]
        self.require(len(losses) == steps
                     and all(math.isfinite(x) for x in losses),
                     f"train qwen3-0.6b: losses {losses}")
        median_ms = statistics.median(run.step_s[1:]) * 1e3
        tokens = 8 * 256
        out = (f"qwen3-0.6b full width (28 layers, bf16, {n_params} params) "
               f"batch 8 seq 256, {steps} steps: step {median_ms:.2f} ms "
               f"(median after the first; first {run.step_s[0] * 1e3:.1f} "
               f"ms), {tokens / median_ms * 1e3:.1f} tokens/s, peak device "
               f"memory {run.peak_bytes / 2 ** 30:.3f} GiB, loss "
               f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        print("train_profile " + json.dumps(self._train_profile(run)),
              flush=True)
        out += "; " + self._kernel_vs_plain_step(run)
        self.reset_counts()
        pre = cli.run(cli.parser().parse_args(
            ["--preset", "100m", "--steps", "300", "--device", "cuda",
             "--seed", "0"]))
        self.read_counts(0, "train 100m", weighted_ce_fwd=300,
                         weighted_ce_bwd=300)
        first, last = pre.history[0]["loss"], pre.history[-1]["loss"]
        self.require(all(math.isfinite(h["loss"]) for h in pre.history)
                     and last < first,
                     f"100m preset: loss {first} -> {last} did not fall")
        pre_ms = statistics.median(pre.step_s[1:]) * 1e3
        return (out + f"; 100m preset (float32, {api.count_params(pre.params)}"
                f" params) 300 steps: loss {first:.4f} -> {last:.4f} "
                f"(improved), step {pre_ms:.2f} ms, "
                f"{tokens / pre_ms * 1e3:.1f} tokens/s, peak "
                f"{pre.peak_bytes / 2 ** 30:.3f} GiB")

    def _train_batch(self, cfg, seed: int) -> dict:
        torch = self.torch
        from repro_torch.data.synthetic import token_stream
        gen = torch.Generator().manual_seed(seed)
        return {"tokens": token_stream(gen, vocab_size=cfg.vocab_size,
                                       batch=8, seq_len=256, device=self.dev),
                "sample_weight": (torch.rand(8, generator=gen)
                                  + 0.5).to(self.dev)}

    def _train_profile(self, run) -> dict:
        """torch.profiler on the run's weights (the CLI's optimizer): two
        whole train steps, then one step's forward + backward and its
        optimizer update alone; for each, wall and device ms, idle share,
        device ms by kind, top kernels."""
        from repro_torch.models import api
        from repro_torch.optim.optimizers import adamw
        from repro_torch.optim.schedules import cosine_with_warmup
        opt = adamw(cosine_with_warmup(3e-4, 5, 20), weight_decay=0.01,
                    grad_clip_norm=1.0)
        step = api.make_train_step(run.cfg, opt)
        batch = self._train_batch(run.cfg, 7)
        state = {"p": run.params, "s": opt.init(run.params)}

        def two_steps():
            for i in range(2):
                state["p"], state["s"], _ = step(state["p"], state["s"],
                                                 batch, 10 + i)

        def fwd_bwd():
            state["g"] = api.loss_and_grads(state["p"], batch, run.cfg)[1]

        def update():
            opt.update(state["g"], state["s"], state["p"], 12)

        two_steps()                      # warm: the optimizer's first use
        return {"two steps": _device_profile(two_steps, top=12),
                "forward+backward": _device_profile(fwd_bwd),
                "optimizer update": _device_profile(update)}

    def _step_pair(self, cfg, params, batch) -> dict:
        """One forward of the train step, then its loss and gradients
        through the kernels and through the plain versions on the same
        logits: the losses, the logits' gradients as phase 10's ratios to
        their tolerances, and the whole gradient's and the worst leaf's
        relative L2 error and the two global norms."""
        torch = self.torch
        from repro_torch.kernels import weighted_ce as wce
        from repro_torch.models import api
        from repro_torch.optim.optimizers import tree_leaves
        loss_k, grads_k, _, logits, leaves = api.loss_and_grads(
            params, batch, cfg, retain_graph=True)
        dl_k = torch.autograd.grad(loss_k, logits, retain_graph=True)[0]
        rows, lab, w = api.next_token_rows(logits, batch, cfg)
        loss_p = (wce.weighted_ce_fwd_plain(rows, lab, w)[0].sum()
                  / w.sum().clamp(min=1e-9))
        dl_p = torch.autograd.grad(loss_p, logits, retain_graph=True)[0]
        grads_p = torch.autograd.grad(loss_p, leaves)
        v = logits.shape[-1]
        g = torch.full_like(w, 1.0 / max(float(w.sum()), 1e-9))
        elem, row = _dlogits_ratios(dl_k.reshape(-1, v), dl_p.reshape(-1, v),
                                    w, g)
        del dl_k, dl_p, logits, leaves
        sq_k = sq_p = sq_d = 0.0
        leaf = 0.0
        for gk, gp in zip(tree_leaves(grads_k), grads_p):
            gk, gp = gk.double(), gp.double()
            dk, dp, dd = (float(torch.sum(a * a))
                          for a in (gk, gp, gk - gp))
            sq_k, sq_p, sq_d = sq_k + dk, sq_p + dp, sq_d + dd
            leaf = max(leaf, math.sqrt(dd / max(dp, 1e-300)))
        return {"loss": (float(loss_k.detach()), float(loss_p.detach())),
                "dlogits": (elem, row),
                "norm": (math.sqrt(sq_k), math.sqrt(sq_p)),
                "whole": math.sqrt(sq_d / sq_p), "leaf": leaf}

    def _kernel_vs_plain_step(self, run) -> str:
        """One step's loss and gradients on the run's weights and a fresh
        batch: the loss through the kernels (the train step's) against the
        plain versions' on the same logits.

        The two paths differ only in the logits' gradient, held per element
        by phase 10's rule; the rest of the backward is the same code.  In
        bf16 (the run's weights) the loss is held to rtol 1e-5, the global
        gradient norm to 1e-3, and the whole gradient's and each leaf's
        relative L2 error to 2^-5: the bf16 roundings of a 28-layer
        backward turn an ulp of difference in the logits' gradient into
        about 1 % in the leaves.  So the same weights are also cast to
        float32, where those roundings are 2^16 times finer, and there
        the whole gradient and each leaf are held to 1e-4."""
        torch = self.torch
        from repro_torch.optim.optimizers import tree_map
        batch = self._train_batch(run.cfg, 11)
        out = []
        for dtype, grad_tol in (("bfloat16", 2.0 ** -5), ("float32", 1e-4)):
            cfg = run.cfg.with_overrides(dtype=dtype)
            params = tree_map(lambda p: p.detach().to(getattr(torch, dtype)),
                              run.params)
            r = self._step_pair(cfg, params, batch)
            del params
            (lk, lp), (nk, np_) = r["loss"], r["norm"]
            self.require(abs(lk - lp) <= 1e-5 * abs(lp),
                         f"{dtype}: kernel loss {lk} != plain {lp} "
                         f"(rtol 1e-5)")
            self.require(abs(nk - np_) <= 1e-3 * np_,
                         f"{dtype}: kernel grad norm {nk} != plain {np_} "
                         f"(rtol 1e-3)")
            self.require(max(r["dlogits"]) <= 1.0,
                         f"{dtype}: the logits' gradient beyond phase 10's "
                         f"rule: {r['dlogits']}")
            self.require(r["whole"] <= grad_tol and r["leaf"] <= grad_tol,
                         f"{dtype}: kernel gradients != plain: relative "
                         f"error {r['whole']}, worst leaf {r['leaf']} "
                         f"(tolerance {grad_tol:.3g})")
            out.append(f"[{dtype}] loss {lk:.6f} vs {lp:.6f}, grad norm "
                       f"{nk:.6g} vs {np_:.6g}, dlogits element / row-sum "
                       f"shares {r['dlogits'][0]:.3g} / "
                       f"{r['dlogits'][1]:.3g}, gradient relative error "
                       f"{r['whole']:.3g}, worst leaf {r['leaf']:.3g} "
                       f"(tolerance {grad_tol:.3g})")
        return "kernel step = plain step on the same logits: " + "; ".join(out)


def main(argv: list[str]) -> int:
    """``--phases 1,8`` runs those phases only (they need phase 1's build
    first), for work on one part; with no arguments, all of them."""
    phases_arg = None
    if argv:
        if len(argv) != 2 or argv[0] != "--phases":
            print("usage: chip_smoke.py [--phases N,M,...]", file=sys.stderr)
            return 2
        phases_arg = sorted({int(n) for n in argv[1].split(",")})
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(SMOKE_DIR, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = f"card: {smi.stdout.strip().splitlines()[0]}"
    print(card, flush=True)
    s = Smoke()
    phases = {1: s.build, 2: s.kernel_vs_plain, 3: s.cli_path, 4: s.mimic,
              5: s.fashion, 6: s.mimic_channel, 7: s.fashion_channel,
              8: s.flash_vs_plain, 9: s.serve, 10: s.ce_vs_plain,
              11: s.train}
    chosen = sorted(phases) if phases_arg is None else phases_arg
    for num in chosen:
        s.phase(num, phases[num])
    if s.failed:
        print(f"chip_smoke: failed {s.failed}", file=sys.stderr)
        return 1
    if chosen != sorted(phases):
        print(f"chip_smoke: phases {chosen} passed (a partial run prints "
              f"no result)")
        return 0
    kernels = [{"name": name, "route": "cuda", **s.kernels[name],
                "launches": s.launches[name]} for name in _counters()]
    print(card)  # again near the end, where a reader of the tail finds it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card, in phases.

  python3 chip_smoke.py            # from the root of a checkout

1. Prints the card's name and power limit; builds the CUDA kernels from
   src/repro_torch/csrc with nvcc (all sources at once) and times the build.
2. Holds each kernel against its plain PyTorch version on the card at the
   main path's sizes and beyond, and times kernel, plain version and bound.
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

Every phase prints one line; a failed phase makes the run exit 1, and then
the last line is not printed.  Before the last line it prints one JSON
object describing each kernel.  The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It exits 2 when torch sees no CUDA device, and fails to import the port when
run outside a checkout.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
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


def _bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_rel(a, b) -> float:
    import torch
    denom = torch.clamp(b.abs(), min=1e-30)
    return float(((a - b).abs() / denom).max())


class Smoke:
    def __init__(self) -> None:
        import torch
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failed: list[str] = []
        self.kernels: dict[str, dict] = {}
        self.launches = {"ignorance_update_unnormalized": 0,
                         "ignorance_normalize": 0}

    def phase(self, num: int, fn) -> None:
        try:
            line = fn()
            print(f"phase {num} ok: {line}", flush=True)
        except Exception as e:  # report and go on: every phase runs
            traceback.print_exc()
            self.failed.append(f"phase {num}")
            print(f"phase {num} FAILED: {type(e).__name__}: {e}", flush=True)

    def require(self, cond: bool, what: str) -> None:
        if not cond:
            raise AssertionError(what)

    # ------------------------------------------------------------ counters
    def reset_counts(self) -> None:
        from repro_torch.kernels import ignorance as ig
        ig.ignorance_update_unnormalized.launches = 0
        ig.normalize_.launches = 0

    def read_counts(self, hops: int, where: str) -> None:
        """The main path's launches since reset_counts: one of each pass per
        hop, added to the run's totals."""
        from repro_torch.kernels import ignorance as ig
        got = (ig.ignorance_update_unnormalized.launches,
               ig.normalize_.launches)
        self.require(got == (hops, hops),
                     f"{where}: kernel launches {got} != hops {hops}")
        self.launches["ignorance_update_unnormalized"] += got[0]
        self.launches["ignorance_normalize"] += got[1]

    # -------------------------------------------------------------- phases
    def build(self) -> str:
        from repro_torch.kernels import _build
        sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                         if f.endswith(".cu"))
        shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
        t0 = time.perf_counter()
        _build.build(*sources)
        secs = time.perf_counter() - t0
        return f"built {sources} with nvcc in {secs:.2f} s"

    def kernel_vs_plain(self) -> str:
        torch = self.torch
        from repro_torch.kernels import ignorance as ig
        from repro_torch.kernels import ops
        tol = 1e-6
        rows = []
        gen = torch.Generator(device=self.dev).manual_seed(0)
        # 420, 10500, 42000: the hops of phases 3, 4, 5
        for n in (1, 210, 420, 1024, 1000, 4096, 10500, 42000, 2 ** 20 + 3,
                  2 ** 20):
            w = torch.rand(n, generator=gen, device=self.dev) + 0.01
            w /= w.sum()
            r = (torch.rand(n, generator=gen, device=self.dev) > 0.4).float()
            a = torch.tensor(1.7, device=self.dev)
            k_w, k_p = ig.ignorance_update_unnormalized(w, r, a)
            p_w, p_p = ig.ignorance_update_unnormalized_plain(w, r, a)
            k_n = ops.ignorance_update(w, r, a)
            p_n = ig.ignorance_update_plain(w, r, a)
            torch.cuda.synchronize()
            errs = (_max_rel(k_w, p_w), _max_rel(k_p, p_p), _max_rel(k_n, p_n))
            self.require(max(errs) <= tol,
                         f"n={n}: max rel err (w_new, partials, w) {errs} > {tol}")
            self.require(torch.equal(ops.ignorance_update(w, r, a), k_n),
                         f"n={n}: two runs differ")
            row = {"n": n, "rel_err": errs,
                   "abs_err": float((k_n - p_n).abs().max())}
            if n in (10500, 42000, 2 ** 20):
                row["kernel_ms"] = _cuda_time_ms(
                    lambda: ops.ignorance_update(w, r, a))
                row["plain_ms"] = _cuda_time_ms(
                    lambda: ig.ignorance_update_plain(w, r, a))
                row["bound_ms"] = _bound_ms(12 * n, 4 * n)[0]
            if n == 42000:      # the main path's largest hop (phase 5)
                self._kernel_rows(w, r, a, k_w, p_w, k_n, p_n)
            rows.append(row)
        print("kernel_table " + json.dumps(
            [{k: v for k, v in r.items() if k != "rel_err"} for r in rows
             if "kernel_ms" in r]), flush=True)
        worst = [max(r["rel_err"][i] for r in rows) for i in range(3)]
        return (f"n in {[r['n'] for r in rows]}: max rel err w_new "
                f"{worst[0]:.3g}, partials {worst[1]:.3g}, normalized w "
                f"{worst[2]:.3g} (tolerance {tol})")

    def _kernel_rows(self, w, r, a, k_w, p_w, k_n, p_n) -> None:
        torch = self.torch
        from repro_torch.kernels import ignorance as ig
        n, nt = w.shape[0], ig.num_tiles(w.shape[0])
        b1, by1 = _bound_ms(4 * (3 * n + 1 + nt), 4 * n)
        self.kernels["ignorance_update_unnormalized"] = {
            "source": "src/repro_torch/csrc/ignorance.cu",
            "replaces": "src/repro/kernels/ignorance.py:46",
            "max_abs_err": float((k_w - p_w).abs().max()),
            "ms": _cuda_time_ms(lambda: ig.ignorance_update_unnormalized(w, r, a)),
            "plain_ms": _cuda_time_ms(
                lambda: ig.ignorance_update_unnormalized_plain(w, r, a)),
            "bound_ms": b1, "bound_by": by1, "library_ms": None}
        # pass 2 on partials summing to 1: in place, repeatable
        buf = k_w.clone()
        unit = torch.zeros(nt, device=self.dev)
        unit[0] = 1.0
        b2, by2 = _bound_ms(4 * (2 * n + nt), n + nt)
        self.kernels["ignorance_normalize"] = {
            "source": "src/repro_torch/csrc/ignorance.cu",
            "replaces": "src/repro/kernels/ops.py:62",
            "max_abs_err": float((k_n - p_n).abs().max()),
            "ms": _cuda_time_ms(lambda: ig.normalize_(buf, unit)),
            "plain_ms": _cuda_time_ms(lambda: ig.normalize_plain(buf, unit)),
            "bound_ms": b2, "bound_by": by2, "library_ms": None}

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
        return (f"fashion n_train=42000 agents=(392,392) logistic steps=300 "
                f"rounds=5: components={len(st.components)} "
                f"acc ascii={a_ascii:.4f} single={a_single:.4f} "
                f"oracle={a_oracle:.4f}; session {secs:.2f} s, "
                f"peak device memory {peak_gib:.3f} GiB, "
                f"ledger {session.transport.total_bits} bits")


def main() -> int:
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
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    s = Smoke()
    s.phase(1, s.build)
    s.phase(2, s.kernel_vs_plain)
    s.phase(3, s.cli_path)
    s.phase(4, s.mimic)
    s.phase(5, s.fashion)
    if s.failed:
        print(f"chip_smoke: failed {s.failed}", file=sys.stderr)
        return 1
    kernels = [{"name": name, "route": "cuda", **row,
                "launches": s.launches[name]}
               for name, row in s.kernels.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

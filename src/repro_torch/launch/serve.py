"""Serving CLI of the port: prefill a prompt, then batched greedy decode
with the KV cache, on the card by default.

Counterpart of ``repro/launch/serve.py``, for every registered arch.
``--use_flash`` sets the ``ArchConfig.use_flash`` switch: prefill then
runs the hand-written CUDA flash-attention kernel and decode the
flash-decode kernel (the int8 one with ``--kv_quant``); without it both
run the reference's einsum attention.  MLA (minicpm3) has no flash path
and raises with it; mamba2 has no attention.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --arch mamba2-130m --batch 2 --prompt_len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
      --use_flash --batch 4 --prompt_len 512 --gen 64 [--kv_quant]

It prints the reference CLI's three lines (prefill, decode rate,
sample).  Weights, prompt and the frontends' inputs are random, each from
its own ``torch.Generator`` seeded from ``--seed`` (the weights on the
run's device), as the reference draws params, tokens and frontend inputs
from three keys, so the numbers differ from the reference CLI's.  The
vision frontend's ``patch_emb`` [B, num_frontend_tokens, d] is prepended
(decode positions start after it); the audio frontend's ``frames``
[B, encoder_seq, d] feed the encoder.  Times are host clock around work
that ends in a device synchronize.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import frontend_inputs
from repro_torch.device import resolve_device
from repro_torch.models import api


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache_mode", default="full", choices=["full", "ring"])
    ap.add_argument("--kv_quant", action="store_true",
                    help="int8 KV cache (GQA archs)")
    ap.add_argument("--use_flash", action="store_true",
                    help="attention through the CUDA flash kernels "
                         "(ArchConfig.use_flash)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


@dataclass
class ServeRun:
    cfg: ArchConfig
    params: dict
    prompt: torch.Tensor        # [B, prompt_len] int32
    frontend: dict              # "patch_emb" or "frames", or nothing
    tokens: torch.Tensor        # [B, gen] int32: the greedy continuation
    s_cache: int
    prefill_s: float
    decode_s: float
    lines: list


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace, params: dict | None = None,
        cfg: ArchConfig | None = None) -> ServeRun:
    """Prefill and ``--gen - 1`` greedy decode steps; ``params`` reuses a
    run's weights (else they are drawn from ``--seed``), ``cfg`` replaces
    the arch's config (``--use_flash`` still applies)."""
    device = resolve_device(args.device)
    if cfg is None:
        cfg = ARCHS[args.arch].reduced() if args.reduced else ARCHS[args.arch]
    cfg = cfg.with_overrides(use_flash=args.use_flash)
    if params is None:
        params = api.init_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed))
    b, s = args.batch, args.prompt_len
    prompt = torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(
                               args.seed + 1)).to(device)
    frontend = frontend_inputs(
        cfg, b, torch.Generator(device=device).manual_seed(args.seed + 2))
    off = cfg.num_frontend_tokens if "patch_emb" in frontend else 0
    total = off + s + args.gen
    s_cache = (api.cache_length(cfg, total) if args.cache_mode == "ring"
               else total)
    prefill = api.make_prefill_step(cfg)
    serve_step = api.make_serve_step(cfg, args.cache_mode)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompt, **frontend})
    caches = api.pad_prefill_cache(caches, cfg, s_cache)
    if args.kv_quant:
        caches = api.quantize_cache(caches, cfg)
    tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    _sync(device)
    prefill_s = time.perf_counter() - t0
    lines = [f"prefill {s} tokens in {prefill_s:.2f}s (cache len {s_cache}, "
             f"mode {args.cache_mode})"]

    generated = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        tok, logits, caches = serve_step(params, caches, tok, off + s + i)
        generated.append(tok)
    out = torch.cat(generated, dim=1)
    _sync(device)
    decode_s = time.perf_counter() - t0
    lines.append(f"decoded {args.gen - 1} steps x batch {b} in "
                 f"{decode_s:.2f}s "
                 f"({(args.gen - 1) * b / max(decode_s, 1e-9):.1f} tok/s)")
    lines.append(f"sample: {out[0].tolist()}")
    return ServeRun(cfg, params, prompt, frontend, out, s_cache, prefill_s,
                    decode_s, lines)


def main(argv: list | None = None) -> None:
    result = run(parser().parse_args(argv))
    for line in result.lines:
        print(line)


if __name__ == "__main__":
    main()

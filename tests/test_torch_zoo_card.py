"""The rest of the model zoo on the card (``gpu``-marked; each test skips
without a card, deciding inside the test; no JAX: the card's machine
holds the port alone).

Every family at ``reduced()`` in float32 (TF32 off), random weights from
a CPU generator copied to the card: the card's prefill and 4 greedy
decode steps against the CPU's on the same weights and tokens, the einsum
path, within 1e-4 of max|logits| and the greedy tokens equal; with
``use_flash`` (the CUDA kernels) against the card's einsum path within
1e-4, with ``flash_attention`` launched once an attention layer a prefill
and ``flash_decode`` once an attention layer a step; the grouped MoE =
the dense within 1e-5 of max|y| and two grouped runs the same bits.
"""
import pytest
import torch

from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import api, moe

ZOO = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "mamba2-130m",
       "jamba-v0.1-52b", "minicpm3-4b", "internvl2-2b", "whisper-tiny"]
FLASH = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "jamba-v0.1-52b",
         "internvl2-2b", "whisper-tiny"]
B, S, GEN = 2, 64, 4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cfg, device):
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen, dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["patch_emb"] = torch.randn(B, cfg.num_frontend_tokens,
                                         cfg.d_model, generator=gen)
    if cfg.frontend == "audio":
        batch["frames"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                      generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


def _run(cfg, params, device):
    """Prefill and GEN greedy steps: (every step's logits, the tokens)."""
    batch = _inputs(cfg, device)
    off = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    with torch.no_grad():
        logits, caches, _ = api.forward(params, batch, cfg)
        caches = api.pad_prefill_cache(caches, cfg, off + S + GEN)
        out, toks = [logits[:, -1]], []
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        for i in range(GEN):
            toks.append(tok)
            logits, caches = api.decode_step(params, caches, tok,
                                             off + S + i, cfg)
            out.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    return [o.float().cpu() for o in out], torch.cat(toks, 1).cpu()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ZOO)
def test_zoo_on_card_equals_cpu(arch):
    dev = _card()
    cfg = ARCHS[arch].reduced()
    params = api.init_params(cfg, torch.Generator().manual_seed(0))
    cpu_logits, cpu_toks = _run(cfg, params, torch.device("cpu"))
    card_logits, card_toks = _run(cfg, _tree_to(params, dev), dev)
    for i, (g, w) in enumerate(zip(card_logits, cpu_logits)):
        assert _rel(g, w) <= 1e-4, (arch, i, _rel(g, w))
    assert torch.equal(card_toks, cpu_toks)


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FLASH)
def test_zoo_flash_kernels_equal_einsum_on_card(arch):
    dev = _card()
    cfg = ARCHS[arch].reduced()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    want, _ = _run(cfg, params, dev)
    fa.flash_attention.launches = fd.flash_decode.launches = 0
    got, _ = _run(cfg.with_overrides(use_flash=True), params, dev)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= 1e-4, (arch, i, _rel(g, w))
    attn = 1 if cfg.layer_pattern else cfg.num_layers
    if cfg.cross_attention:       # the encoder, self and cross attention
        prefill, step = cfg.encoder_layers + 2 * attn, 2 * attn
    else:
        prefill, step = attn, attn
    assert fa.flash_attention.launches == prefill
    assert fd.flash_decode.launches == step * GEN


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-235b-a22b"])
def test_grouped_moe_equals_dense_on_card(arch):
    dev = _card()
    cfg = ARCHS[arch].reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.float32, device=dev)
    x = torch.randn(2, 256, cfg.d_model, generator=gen, device=dev)
    dense, aux_d = moe.moe_apply(p, x, cfg, "dense")
    gmm, aux_g = moe.moe_apply(p, x, cfg, "gmm")
    assert _rel(gmm, dense) <= 1e-5
    assert torch.equal(aux_d, aux_g)
    assert torch.equal(moe.moe_apply(p, x, cfg, "gmm")[0], gmm)

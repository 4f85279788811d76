"""The rest of the model zoo's serve path against the JAX package's: MoE
(granite, qwen3-moe), Mamba2 SSD (mamba2), the Jamba hybrid, MLA
(minicpm3), the vision frontend (internvl2) and the encoder-decoder
(whisper), each at ``reduced()`` in float32 (``torch_zoo_common``).

Both packages run the reference's weights (carried across by the
converter) on the same tokens and frontend inputs.  Held, each within
1e-4 of max|reference| (summation order, ~1e-6 here): the parameter tree
and count, prefill logits, the aux loss and every cache leaf,
``pad_prefill_cache``, 4 greedy decode steps (tokens exactly) and the
caches after them; ``quantize_cache`` exactly on one input (int8 values
and scales), then 4 int8 decode steps from the reference's quantized
cache; with ``use_flash`` the same through the kernels' plain versions
(``chip_smoke.py`` phase 19 and ``test_torch_zoo_card.py`` run the CUDA
kernels); ``attn_impl="chunked"`` for GQA and MLA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import api as japi
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from torch_zoo_common import (FLASH_ZOO, GEN, S, ZOO, ZooRef, assert_close,
                              cfgs, leaf_pairs, np_tree, tbatch,
                              to_port_cache)

_REFS = {}


def ref_of(arch) -> ZooRef:
    """One reference run per arch, shared by this module's tests."""
    if arch not in _REFS:
        _REFS[arch] = ZooRef(arch)
    return _REFS[arch]


def _prefill(r, tcfg):
    params = r.port_params(tcfg)
    with torch.no_grad():
        logits, caches, aux = tapi.forward(params, tbatch(r.batch), tcfg)
    return params, logits, caches, aux


@pytest.mark.parametrize("arch", ZOO)
def test_param_tree_and_count_match_reference(arch):
    """The converter takes the reference's tree leaf for leaf (shapes and
    the SSM's float32 leaves); the counts agree at reduced and at full
    width (the full tree on the meta device, the reference's by
    eval_shape)."""
    r = ref_of(arch)
    params = r.port_params()
    assert tapi.count_params(params) == japi.count_params(r.params)
    for path, got, want in _flat_pairs(params, np_tree(r.params)):
        assert tuple(got.shape) == want.shape, path
        assert np.array_equal(got.numpy(), want), path
    full = tapi.init_params(TARCHS[arch])
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: japi.init_params(jax.random.key(0),
                                                JARCHS[arch]))))
    assert tapi.count_params(full) == want


def _flat_pairs(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return [p for k in want for p in _flat_pairs(got[k], want[k],
                                                     f"{path}/{k}")]
    return [(path, got, want)]


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_and_caches_match_reference(arch):
    r = ref_of(arch)
    _, logits, caches, aux = _prefill(r, r.tcfg)
    assert_close(logits, r.logits, "logits")
    np.testing.assert_allclose(float(aux), float(r.aux), rtol=1e-5)
    for path, got, want in leaf_pairs(caches, r.caches):
        assert got.dtype == torch.from_numpy(np.zeros(0, np.asarray(
            want).dtype)).dtype, path
        assert_close(got, want, path)
    last, _ = tapi.make_prefill_step(r.tcfg)(r.port_params(),
                                             tbatch(r.batch))
    assert_close(last, r.logits[:, -1:], "prefill step")


@pytest.mark.parametrize("arch", ZOO)
def test_greedy_decode_matches_reference(arch):
    r = ref_of(arch)
    params, logits, caches, _ = _prefill(r, r.tcfg)
    caches = tapi.pad_prefill_cache(caches, r.tcfg, r.s_cache)
    for path, got, want in leaf_pairs(caches, r.padded):
        assert_close(got, want, "padded " + path)
    got, caches = r.port_decode(r.tcfg, params, caches, logits)
    want, jcaches = r.decode(r.padded)
    for i, ((gl, gt), (wl, wt)) in enumerate(zip(got, want)):
        assert_close(gl, wl, f"step {i}")
        assert np.array_equal(gt.numpy(), wt), f"step {i}: tokens differ"
    for path, g, w in leaf_pairs(caches, jcaches):
        assert_close(g, w, "after decode " + path)


@pytest.mark.parametrize("arch", ZOO)
def test_pad_and_quantize_cache_match_reference(arch):
    """On the reference's own prefill cache: the padding bit for bit, and
    the int8 cache's values and scales exactly the reference's compiled
    quantize (MLA latents, the cross K/V and SSM states kept as they
    are); then 4 decode steps on the reference's quantized cache."""
    r = ref_of(arch)
    padded = tapi.pad_prefill_cache(to_port_cache(r.caches, r.tcfg), r.tcfg,
                                    r.s_cache)
    for path, g, w in leaf_pairs(padded, r.padded):
        assert np.array_equal(g.numpy(), np.asarray(w)), path
    jq = jax.jit(lambda c: japi.quantize_cache(c, r.jcfg))(r.padded)
    tq = tapi.quantize_cache(to_port_cache(r.padded, r.tcfg), r.tcfg)
    for path, g, w in leaf_pairs(tq, jq):
        assert np.array_equal(g.numpy(), np.asarray(w)), path
    params = r.port_params()
    got, _ = r.port_decode(r.tcfg, params, to_port_cache(jq, r.tcfg),
                           torch.from_numpy(np.array(r.logits)))
    want, _ = r.decode(jq)
    for i, ((gl, gt), (wl, wt)) in enumerate(zip(got, want)):
        assert_close(gl, wl, f"int8 step {i}")
        assert np.array_equal(gt.numpy(), wt), f"int8 step {i}"


@pytest.mark.parametrize("arch", FLASH_ZOO)
def test_use_flash_matches_reference_and_counts_calls(arch, monkeypatch):
    """With use_flash every attention of a prefill calls
    ops.flash_attention (the encoder's and the cross-attention with
    causal=False) and every attention of a decode step ops.flash_decode
    (the cross cache at pos T - 1); the results are the reference's."""
    calls = {"attention": 0, "bidirectional": 0, "decode": 0}
    real_fa, real_fd = tops.flash_attention, tops.flash_decode

    def fa(*a, **kw):
        calls["attention"] += 1
        calls["bidirectional"] += not kw["causal"]
        return real_fa(*a, **kw)

    def fd(*a, **kw):
        calls["decode"] += 1
        return real_fd(*a, **kw)

    monkeypatch.setattr(tops, "flash_attention", fa)
    monkeypatch.setattr(tops, "flash_decode", fd)
    r = ref_of(arch)
    tcfg = r.tcfg.with_overrides(use_flash=True)
    params, logits, caches, _ = _prefill(r, tcfg)
    assert_close(logits, r.logits, "flash prefill")
    caches = tapi.pad_prefill_cache(caches, tcfg, r.s_cache)
    got, _ = r.port_decode(tcfg, params, caches, logits)
    want, _ = r.decode(r.padded)
    for i, ((gl, gt), (wl, wt)) in enumerate(zip(got, want)):
        assert_close(gl, wl, f"flash step {i}")
        assert np.array_equal(gt.numpy(), wt), f"flash step {i}"
    units = {"jamba-v0.1-52b": 1}.get(arch, tcfg.num_layers)
    if tcfg.cross_attention:       # encoder, self and cross
        want_calls = {"attention": tcfg.encoder_layers + 2 * units,
                      "bidirectional": tcfg.encoder_layers + units,
                      "decode": 2 * units * GEN}
    else:
        want_calls = {"attention": units, "bidirectional": 0,
                      "decode": units * GEN}
    assert calls == want_calls


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "minicpm3-4b"])
def test_chunked_attention_matches_reference(arch):
    """attn_impl='chunked' with attn_chunk 8 < S: GQA's _sdpa_q_chunked
    and MLA's chunked branch, against the reference's, and against the
    unchunked port."""
    r = ZooRef(arch, attn_impl="chunked", attn_chunk=8)
    _, logits, caches, _ = _prefill(r, r.tcfg)
    assert_close(logits, r.logits, "chunked logits")
    for path, g, w in leaf_pairs(caches, r.caches):
        assert_close(g, w, path)
    _, plain, _, _ = _prefill(r, r.tcfg.with_overrides(attn_impl="einsum"))
    assert_close(logits, plain.numpy(), "chunked vs einsum")


def test_mla_ring_cache_decode_matches_reference():
    """MLA's decode through a ring cache (window 8 over 12 slots): the
    latents' slots and validity as the reference's."""
    r = ZooRef("minicpm3-4b", window=8)
    params = r.port_params()
    jring = japi.pad_prefill_cache(
        jax.tree.map(lambda a: a[:, :, -12:], r.caches), r.jcfg, 12)
    tring = to_port_cache(jring, r.tcfg)
    tok = jnp.argmax(r.logits[:, -1], -1).astype(jnp.int32)[:, None]
    for i in range(3):
        pos = S + i
        jl, jring = japi.decode_step(r.params, jring, tok,
                                     jnp.asarray(pos, jnp.int32), r.jcfg,
                                     "ring")
        with torch.no_grad():
            tl, tring = tapi.decode_step(params, tring,
                                         torch.from_numpy(np.array(tok)),
                                         pos, r.tcfg, "ring")
        assert_close(tl, jl, f"ring step {i}")
        tok = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
    for path, g, w in leaf_pairs(tring, jring):
        assert_close(g, w, path)


def test_init_cache_layouts_match_reference():
    """init_cache's tree, shapes and dtypes equal the reference's for every
    family (MLA latents, SSM states with a float32 ssm, whisper's cross
    cache), and kv_quant's int8 leaves."""
    for arch in ZOO:
        for kv_quant in (False, True):
            r_cfg, t_cfg = cfgs(arch, kv_quant=kv_quant)
            want = jax.eval_shape(lambda: japi.init_cache(r_cfg, 2, 40))
            got = tapi.init_cache(t_cfg, 2, 40, device="cpu")
            for path, g, w in leaf_pairs(got, want):
                assert tuple(g.shape) == w.shape, (arch, path)
                assert str(g.dtype).split(".")[-1] == str(w.dtype), (arch,
                                                                    path)


def test_ssm_state_is_float32_in_a_bf16_model():
    """The reference's float32 leaves stay float32 in a bf16 model: the SSM
    params A_log, D, dt_bias and the ssm state of the cache."""
    cfg = TARCHS["mamba2-130m"].reduced().with_overrides(dtype="bfloat16")
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0))
    sub = params["layers"]["sub0"]["ssm"]
    assert {k: sub[k].dtype for k in ("A_log", "D", "dt_bias")} == {
        "A_log": torch.float32, "D": torch.float32, "dt_bias": torch.float32}
    assert sub["in_x"].dtype == torch.bfloat16
    cache = tapi.init_cache(cfg, 1, 8, device="cpu")["sub0"]
    assert isinstance(cache, tssm.SSMState)
    assert cache.ssm.dtype == torch.float32
    assert cache.conv_x.dtype == torch.bfloat16
    assert isinstance(tapi.init_cache(TARCHS["minicpm3-4b"].reduced(), 1, 8,
                                      device="cpu")["sub0"], tattn.KVCache)

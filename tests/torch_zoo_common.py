"""Shared by the model-zoo parity tests (``test_torch_zoo*.py``,
``test_torch_moe.py``, ``test_torch_ssm.py``): one reference run of an
architecture at ``reduced()`` (float32) and the port on the same weights
(the reference's ``init_params`` carried across by
``convert.model_params_from_numpy``), tokens and frontend inputs (numpy,
from a seed).

Tolerance: ``TOL`` of max|reference| for logits and for every cache leaf
(the two packages sum in other orders: ~1e-6 here), greedy tokens and
int8 cache values exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import api as japi
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import api as tapi

B, S, GEN = 2, 32, 4
TOL = 1e-4                   # of max|reference|
ZOO = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "mamba2-130m",
       "jamba-v0.1-52b", "minicpm3-4b", "internvl2-2b", "whisper-tiny"]
# the families with GQA attention, which use_flash routes to the kernels
FLASH_ZOO = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b",
             "jamba-v0.1-52b", "internvl2-2b", "whisper-tiny"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def cfgs(arch, **kw):
    return (JARCHS[arch].reduced().with_overrides(**kw),
            TARCHS[arch].reduced().with_overrides(**kw))


def batch_of(cfg, rng, b=B, s=S):
    """Tokens [b, s] int32 and the frontend's input, numpy."""
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patch_emb"] = rng.standard_normal(
            (b, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def leaf_pairs(got, want, path=""):
    """(path, port tensor, reference array) for every cache leaf, matched
    by dict key and NamedTuple field."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        return [p for k in sorted(want)
                for p in leaf_pairs(got[k], want[k], f"{path}/{k}")]
    assert type(got).__name__ == type(want).__name__, (path, type(got))
    return [(f"{path}.{f}", getattr(got, f), getattr(want, f))
            for f in want._fields]


def to_port_cache(jcache, tcfg):
    """A reference cache tree as the port's (the same NamedTuples)."""
    from repro_torch.models import attention as tattn
    from repro_torch.models import ssm as tssm
    kinds = {"KVCache": tattn.KVCache, "QuantKVCache": tattn.QuantKVCache,
             "SSMState": tssm.SSMState}
    if isinstance(jcache, dict):
        return {k: to_port_cache(v, tcfg) for k, v in jcache.items()}
    return kinds[type(jcache).__name__](
        *(torch.from_numpy(np.array(a)) for a in jcache))


def assert_close(got, want, what="", tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


class ZooRef:
    """One reference run: params, prefill, padded cache and GEN greedy
    decode steps (jit, as the JAX serve CLI runs them)."""

    def __init__(self, arch, seed=0, **kw):
        self.arch = arch
        self.jcfg, self.tcfg = cfgs(arch, **kw)
        self.params = japi.init_params(jax.random.key(seed), self.jcfg)
        self.batch = batch_of(self.jcfg, np.random.default_rng(seed))
        self.off = (self.jcfg.num_frontend_tokens
                    if self.jcfg.frontend == "vision" else 0)
        self.logits, self.caches, self.aux = jax.jit(
            lambda p, b: japi.forward(p, b, self.jcfg))(
                self.params, jbatch(self.batch))
        self.s_cache = self.off + S + GEN
        self.padded = japi.pad_prefill_cache(self.caches, self.jcfg,
                                             self.s_cache)
        self.step = jax.jit(japi.make_serve_step(self.jcfg))

    def port_params(self, tcfg=None):
        return model_params_from_numpy(tcfg or self.tcfg,
                                       np_tree(self.params), device="cpu")

    def decode(self, caches, steps=GEN):
        tok = jnp.argmax(self.logits[:, -1], -1).astype(jnp.int32)[:, None]
        out = []
        for i in range(steps):
            tok, logits, caches = self.step(
                self.params, caches, tok,
                jnp.asarray(self.off + S + i, jnp.int32))
            out.append((np.asarray(logits), np.asarray(tok)))
        return out, caches

    def port_decode(self, tcfg, params, caches, first_logits, steps=GEN):
        step = tapi.make_serve_step(tcfg)
        tok = torch.argmax(first_logits[:, -1], -1).to(torch.int32)[:, None]
        out = []
        with torch.no_grad():
            for i in range(steps):
                tok, logits, caches = step(params, caches, tok,
                                           self.off + S + i)
                out.append((logits, tok))
        return out, caches

"""The rest of the model zoo's training path, weight carrier, CLIs and what
still raises, against the JAX package (``torch_zoo_common``: each arch at
``reduced()``, float32, the reference's weights carried across).

Held: a train step's loss (``router_aux_coef * aux`` added for an MoE),
aux and gradients within 1e-5 (gradients: of each leaf's
max|reference|) for the hybrid, MLA, vision (the loss on text only) and
encoder-decoder families (MoE and SSM: ``test_torch_moe.py``,
``test_torch_ssm.py``); the converter's round trip of every family's tree
at bfloat16 bit for bit, each leaf in the reference's dtype (the SSM's
float32 leaves too), and of an AdamW state over it; a ``NeuralCore.fit``
over an MLA backbone (1e-4 of max|logits|); both CLIs on every arch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.convert import (model_params_from_numpy,
                                 opt_state_from_numpy)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.learners.neural import NeuralBackbone as TNeural
from repro_torch.models import api as tapi
from repro_torch.models import classifier as tclassifier
from repro_torch.optim import optimizers as topt
from test_torch_moe import (_ref_loss, _train_case, assert_grads_close,
                            neural_fit_matches_reference)
from torch_zoo_common import cfgs, jbatch, np_tree, tbatch


# jamba's widths with its pattern cut to (ssm + MLP, attn + MoE): the
# reduced unit of eight takes the reference ~25 s to compile here
HYBRID = dict(num_layers=2, layer_pattern=("ssm", "attn"))


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "minicpm3-4b",
                                  "internvl2-2b", "whisper-tiny"])
def test_train_step_matches_reference(arch):
    kw = HYBRID if arch == "jamba-v0.1-52b" else {}
    jcfg, tcfg, params, batch = _train_case(arch, **kw)
    (jl, ja), jg = jax.jit(jax.value_and_grad(_ref_loss(jcfg),
                                              has_aux=True))(
        params, jbatch(batch))
    tp = model_params_from_numpy(tcfg, np_tree(params), device="cpu")
    tl, tg, ta = tapi.loss_and_grads(tp, tbatch(batch), tcfg)[:3]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    assert_grads_close(tg, jg)
    step = tapi.make_train_step(tcfg, topt.adamw(1e-3))
    _, _, m = step(tp, topt.adamw(1e-3).init(tp), tbatch(batch), 0)
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux_loss"]), float(ja), rtol=1e-5)


def _dtypes(tree, path=""):
    if isinstance(tree, dict):
        return {p: d for k, v in tree.items()
                for p, d in _dtypes(v, f"{path}/{k}").items()}
    return {path: str(tree.dtype).split(".")[-1]}


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_weight_carrier_round_trips_bf16_trees(arch):
    """The reference's bf16 tree through model_params_from_numpy and back
    equals it bit for bit, each leaf in the reference's own dtype (the
    SSM's A_log, D, dt_bias float32, not rounded to bf16); the same for
    an AdamW state over it (opt_state_from_numpy)."""
    jcfg, tcfg = cfgs(arch, dtype="bfloat16")
    params = japi.init_params(jax.random.key(0), jcfg)
    got = model_params_from_numpy(tcfg, np_tree(params), device="cpu")
    want = np_tree(params)
    assert _dtypes(got) == _dtypes(want)

    def back(t):
        return (t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16
                else t.numpy())

    flat_got = jax.tree.leaves(jax.tree.map(back, got))
    flat_want = [np.asarray(a).view(np.uint16) if a.dtype.name == "bfloat16"
                 else np.asarray(a) for a in jax.tree.leaves(want)]
    assert all(np.array_equal(g, w) for g, w in zip(flat_got, flat_want))
    state = jopt.adamw(1e-3).init(params)
    tstate = opt_state_from_numpy(tcfg, np_tree(state), device="cpu")
    assert _dtypes(tstate["m"]) == _dtypes(want)


def test_neural_core_fit_over_mla_backbone():
    neural_fit_matches_reference("minicpm3-4b")


def test_what_stays_unported_raises():
    """use_flash with MLA (the kernels take one head dim for q, k and v);
    the encoder-decoder as a classifier or neural backbone.  Expert
    parallelism (moe_impl='ep_a2a') is in: its init is the grouped
    config's, and without a mesh it runs the grouped path.  Tensor
    parallelism in a Trainer mesh is in too (tests/test_torch_tp.py)."""
    _, moe = cfgs("granite-moe-1b-a400m")
    ep = tapi.init_params(moe.with_overrides(moe_impl="ep_a2a"),
                          torch.Generator().manual_seed(0))
    gmm = tapi.init_params(moe, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(topt.tree_leaves(ep),
                                                 topt.tree_leaves(gmm)))
    _, mla = cfgs("minicpm3-4b", use_flash=True)
    for call in (lambda: tapi.init_params(mla),
                 lambda: tapi.forward({}, {"tokens": torch.zeros(
                     1, 4, dtype=torch.int32)}, mla),
                 lambda: tserve.main(["--device", "cpu", "--arch",
                                      "minicpm3-4b", "--use_flash"])):
        with pytest.raises(NotImplementedError, match="MLA"):
            call()
    _, whisper = cfgs("whisper-tiny")
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        tclassifier.init_params(whisper, 3)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        TNeural(cfg=whisper, steps=1, device="cpu").core(3).init(0, (5,))
    with pytest.raises(ValueError, match="attn_impl"):
        tapi.init_params(moe.with_overrides(attn_impl="flash"))


# ---------------------------------------------------------------- CLIs
@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_serve_cli_runs_every_arch_on_cpu(arch, capsys):
    tserve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                 "--prompt_len", "8", "--gen", "3"])
    lines = capsys.readouterr().out.strip().splitlines()
    cfg = TARCHS[arch].reduced()
    off = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    assert len(lines) == 3
    assert lines[0].startswith("prefill 8 tokens in ")
    assert f"(cache len {off + 11}, mode full)" in lines[0]
    assert lines[1].startswith("decoded 2 steps x batch 2 in ")
    sample = [int(t) for t in lines[2].removeprefix("sample: ")
              .strip("[]").split(",")]
    assert len(sample) == 3 and all(0 <= t < cfg.vocab_size for t in sample)


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_train_cli_runs_every_arch_on_cpu(arch, capsys):
    ttrain.main(["--device", "cpu", "--arch", arch, "--reduced",
                 "--steps", "2", "--batch", "2", "--seq", "8"])
    lines = capsys.readouterr().out.strip().splitlines()
    n = tapi.count_params(tapi.init_params(TARCHS[arch].reduced()))
    assert lines[0] == f"arch={arch} params={n:,} steps=2 batch=2 seq=8"
    losses = [float(ln.split()[3]) for ln in lines[1:3]]
    assert all(np.isfinite(losses)), lines
    assert lines[3].startswith("loss: ")

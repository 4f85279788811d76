"""The port's training path (``repro_torch.models.api`` training half,
``optim``, ``data.pipeline``/``token_stream``, ``train.trainer``,
``train.checkpoint`` save/restore, ``launch.train``) against the JAX
package's.

Configs are reduced (1-2 layers, widths <= 256, vocab <= 512) and float32.
Both packages get the same inputs: logits, tokens and weights made with
numpy from a seed, the reference's own parameter init converted with
``model_params_from_numpy`` / ``opt_state_from_numpy``, the reference's
token draws.  The port's loss runs through ``ops.weighted_ce`` (its plain
versions here on the CPU; ``chip_smoke.py`` and the ``gpu`` test run the
CUDA kernels), the reference's through its einsum.

Tolerances: the loss rtol 1e-6 and its logits gradient atol 1e-6 (the same
float32 function, other summation orders); optimizers atol 1e-6 + rtol
1e-6 over 20 steps; schedules rtol 1e-6; five train steps: losses rtol
1e-5, params atol 1e-5 + rtol 1e-5 (AdamW amplifies ulp-level gradient
differences, ROADMAP Queue 3); tokens and indices exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JARCHS
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import checkpoint as jckpt
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.convert import model_params_from_numpy, opt_state_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import weighted_ce as twce
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import transformer as ttransformer
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "qwen3-0.6b"
STEP_TOL = dict(atol=1e-5, rtol=1e-5)


def _jcfg(**kw):
    return JARCHS[ARCH].reduced().with_overrides(num_kv_heads=2, **kw)


def _tcfg(**kw):
    return TARCHS[ARCH].reduced().with_overrides(num_kv_heads=2, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_tree_close(got: dict, want, **tol):
    got, want = _flat(got), _flat(_np(want))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   err_msg=k, **tol)


# ---------------------------------------------------------------- loss
def _loss_inputs(cfg_j, b=3, s=12, prefix=0, seed=0):
    rng = np.random.default_rng(seed)
    v = cfg_j.vocab_size
    logits = (rng.standard_normal((b, prefix + s, v)) * 2).astype(np.float32)
    tokens = rng.integers(0, v, (b, s)).astype(np.int32)
    return (logits, tokens, rng.uniform(0.1, 2.0, b).astype(np.float32),
            (rng.uniform(size=(b, s)) > 0.3).astype(np.float32))


@pytest.mark.parametrize("case", ["plain", "sample_weight", "loss_mask",
                                  "both", "vision_prefix"])
def test_loss_matches_reference(case):
    """weighted_next_token_loss and its logits gradient against the
    reference's einsum, on the same logits, tokens, sample_weight and
    loss_mask (and a vision model's image prefix, stripped)."""
    prefix = 4 if case == "vision_prefix" else 0
    if prefix:
        jcfg = JARCHS["internvl2-2b"].reduced()
        tcfg = TARCHS["internvl2-2b"].reduced()
    else:
        jcfg, tcfg = _jcfg(), _tcfg()
    logits, tokens, sw, mask = _loss_inputs(jcfg, prefix=prefix)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens)}
    if case in ("sample_weight", "both", "vision_prefix"):
        jb["sample_weight"], tb["sample_weight"] = (jnp.asarray(sw),
                                                    torch.from_numpy(sw))
    if case in ("loss_mask", "both", "vision_prefix"):
        jb["loss_mask"], tb["loss_mask"] = (jnp.asarray(mask),
                                            torch.from_numpy(mask))
    if prefix:
        pe = np.zeros((3, prefix, jcfg.d_model), np.float32)
        jb["patch_emb"], tb["patch_emb"] = jnp.asarray(pe), torch.from_numpy(pe)
    jloss, jgrad = jax.value_and_grad(
        lambda x: japi.weighted_next_token_loss(x, jb, jcfg))(
            jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = tapi.weighted_next_token_loss(x, tb, tcfg)
    (grad,) = torch.autograd.grad(loss, x)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-6)


def test_weighted_loss_respects_ignorance():
    """A zero ignorance weight removes a sample from the loss (WST), as
    tests/test_models_smoke.py asserts for the reference: w = [1, 0, 0]
    gives sample 0's loss alone, and non-uniform w moves the loss."""
    cfg = _tcfg()
    logits, tokens, _, _ = _loss_inputs(_jcfg(), seed=1)
    x, t = torch.from_numpy(logits), torch.from_numpy(tokens)
    one = tapi.weighted_next_token_loss(
        x, {"tokens": t, "sample_weight": torch.tensor([1.0, 0.0, 0.0])}, cfg)
    alone = tapi.weighted_next_token_loss(x[:1], {"tokens": t[:1]}, cfg)
    uniform = tapi.weighted_next_token_loss(x, {"tokens": t}, cfg)
    skewed = tapi.weighted_next_token_loss(
        x, {"tokens": t, "sample_weight": torch.tensor([0.2, 1.0, 3.0])}, cfg)
    assert abs(float(one) - float(alone)) < 1e-6
    assert abs(float(skewed) - float(uniform)) > 1e-3


def test_loss_hands_the_kernel_views_of_the_logits():
    """The loss hands the kernel the [B, S, V] logits as B * S rows (a view,
    no copy), weight 0 at each sequence's last position."""
    cfg = _tcfg()
    logits, tokens, sw, _ = _loss_inputs(_jcfg(), seed=2)
    x = torch.from_numpy(logits)
    rows, labels, w = tapi.next_token_rows(
        x, {"tokens": torch.from_numpy(tokens),
            "sample_weight": torch.from_numpy(sw)}, cfg)
    assert rows.data_ptr() == x.data_ptr() and rows.shape == (36, 512)
    assert labels.dtype == torch.int32 and w.dtype == torch.float32
    w = w.reshape(3, 12)
    assert torch.equal(w[:, -1], torch.zeros(3))
    assert torch.equal(w[:, 0], torch.from_numpy(sw))
    assert torch.equal(labels.reshape(3, 12)[:, :-1],
                       torch.from_numpy(tokens[:, 1:]))


# ----------------------------------------------------------- optimizers
def _tree(rng):
    return {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "b": {"c": {"d": rng.standard_normal(5).astype(np.float32)},
                  "e": rng.standard_normal((2, 2)).astype(np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.01)),
    ("adamw", dict(weight_decay=0.01, grad_clip_norm=0.5)),
    ("sgd", dict(momentum=0.9)),
    ("sgd", dict(momentum=0.9, nesterov=True, clip=0.5))])
def test_optimizers_on_nested_trees_match_reference(name, kw):
    """AdamW and SGD over a nested tree, 20 steps of the same gradients,
    with a warmup-cosine rate; the reference's tree.map against the port's
    leaf-by-leaf map."""
    clip = kw.pop("clip", None)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jo = getattr(jopt, name)(jsched.cosine_with_warmup(0.05, 3, 20), **kw)
    to = getattr(topt, name)(tsched.cosine_with_warmup(0.05, 3, 20), **kw)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(20):
        grads = _tree(rng)
        jg, tg = jax.tree.map(jnp.asarray, grads), _to_torch(grads)
        if clip:
            jg = jopt.clip_by_global_norm(jg, clip)
            tg = topt.clip_by_global_norm(tg, clip)
            np.testing.assert_allclose(float(topt.global_norm(tg)),
                                       float(jopt.global_norm(jg)),
                                       rtol=1e-6)
        jp, js = jo.update(jg, js, jp, jnp.asarray(step, jnp.int32))
        tp, ts = to.update(tg, ts, tp, step)
        _assert_tree_close(tp, jp, atol=1e-6, rtol=1e-6)
    _assert_tree_close({"s": ts}, {"s": js}, atol=1e-6, rtol=1e-6)


def test_adamw_keeps_bf16_moments():
    """Moments are zeros_like the params (bf16 at full width), and the
    update is float32 math rounded once to each leaf's dtype."""
    p = {"x": {"y": torch.ones(4, dtype=torch.bfloat16)}}
    opt = topt.adamw(1e-2, weight_decay=0.1)
    state = opt.init(p)
    assert state["m"]["x"]["y"].dtype == torch.bfloat16
    g = {"x": {"y": torch.full((4,), 0.5, dtype=torch.bfloat16)}}
    new, state = opt.update(g, state, p, 0)
    assert new["x"]["y"].dtype == torch.bfloat16
    assert state["v"]["x"]["y"].dtype == torch.bfloat16
    want = torch.tensor(1.0 - 1e-2 * (1.0 + 0.1)).to(torch.bfloat16)
    assert torch.equal(new["x"]["y"], want.expand(4))


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("cosine_with_warmup", (3e-4, 10, 200)),
    ("cosine_with_warmup", (1e-2, 5, 50, 1e-4)),
    ("linear_decay", (3e-4, 10, 200))])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    want = np.array([float(jf(jnp.asarray(s, jnp.int32)))
                     for s in range(201)], np.float32)
    got = np.array([float(tf(s)) for s in range(201)], np.float32)
    assert all(tf(s).dtype == torch.float32 for s in (0, 7))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("copy_prob", [0.35, 0.9])
def test_token_chain_given_reference_draws_equals_its_tokens(copy_prob):
    key, v, b, s = jax.random.key(3), 1000, 4, 64
    want = jsyn.token_stream(key, vocab_size=v, batch=b, seq_len=s,
                             copy_prob=copy_prob)
    kt, kl = jax.random.split(key)       # the reference's draws
    noise = jax.random.randint(kt, (b, s), 0, v)
    use_map = jax.random.bernoulli(kl, copy_prob, (b, s))
    got = tsyn.markov_chain(np.asarray(noise), np.asarray(use_map), v)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_token_stream_and_lm_batches_on_the_port():
    gen = torch.Generator().manual_seed(0)
    toks = tsyn.token_stream(gen, vocab_size=50, batch=3, seq_len=20,
                             copy_prob=1.0, device="cpu")
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (3, 20)
    # copy_prob 1: the affine map all the way
    assert torch.equal(toks[:, 1:], (toks[:, :-1] * 31 + 7) % 50)
    data = tpipe.lm_batches(torch.Generator().manual_seed(0), vocab_size=64,
                            batch=2, seq_len=8, device="cpu")
    a, b = next(data), next(data)
    assert set(a) == {"tokens", "sample_weight"}
    assert torch.equal(a["sample_weight"], torch.ones(2))
    assert not torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].max()) < 64 and int(a["tokens"].min()) >= 0


@pytest.mark.parametrize("n,bs,drop", [(10, 3, True), (10, 3, False),
                                       (64, 8, True)])
def test_batched_indices_match_reference(n, bs, drop):
    ja = jpipe.batched_indices(n, bs, seed=5, drop_remainder=drop)
    ta = tpipe.batched_indices(n, bs, seed=5, drop_remainder=drop)
    for _ in range(12):
        np.testing.assert_array_equal(next(ta), next(ja))


# ----------------------------------------------------------- train step
class RefRun:
    """The reference's init and jitted train step over the reference's
    lm_batches tokens with non-uniform sample weights; the port starts
    from the converted init and optimizer state."""

    def __init__(self, microbatches: int = 1, steps: int = 5):
        self.jcfg = _jcfg(microbatches=microbatches)
        self.tcfg = _tcfg(microbatches=microbatches)
        self.jopt = jopt.adamw(jsched.cosine_with_warmup(1e-2, 2, steps),
                               weight_decay=0.01, grad_clip_norm=1.0)
        self.topt = topt.adamw(tsched.cosine_with_warmup(1e-2, 2, steps),
                               weight_decay=0.01, grad_clip_norm=1.0)
        self.params = japi.init_params(jax.random.key(0), self.jcfg)
        self.state = self.jopt.init(self.params)
        data = jpipe.lm_batches(jax.random.key(1), vocab_size=512, batch=4,
                                seq_len=16, copy_prob=0.6)
        rng = np.random.default_rng(0)
        self.batches = []
        for _ in range(steps):
            b = next(data)
            self.batches.append(
                {"tokens": np.array(b["tokens"]),
                 "sample_weight": rng.uniform(0.2, 2.0, 4).astype(np.float32)})

    def port_start(self):
        return (model_params_from_numpy(self.tcfg, _np(self.params),
                                        device="cpu"),
                opt_state_from_numpy(self.tcfg, _np(self.state),
                                     device="cpu"))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """Five steps of make_train_step (AdamW with clipping and a warmup
    schedule, as the CLI) against the reference's jitted step."""
    r = RefRun(microbatches)
    jstep = jax.jit(japi.make_train_step(r.jcfg, r.jopt))
    tstep = tapi.make_train_step(r.tcfg, r.topt)
    jp, js = r.params, r.state
    tp, ts = r.port_start()
    for i, b in enumerate(r.batches):
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b),
                           jnp.asarray(i, jnp.int32))
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, i)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert float(tm["aux_loss"]) == float(jm["aux_loss"]) == 0.0
        _assert_tree_close(tp, jp, **STEP_TOL)
    _assert_tree_close(ts, js, **STEP_TOL)


def test_remat_block_gives_the_same_step():
    """remat='block' recomputes each layer under torch.utils.checkpoint: the
    same step as without it."""
    r = RefRun(steps=1)
    b = {k: torch.from_numpy(v) for k, v in r.batches[0].items()}
    out = []
    for remat in ("none", "block"):
        tp, ts = r.port_start()
        step = tapi.make_train_step(r.tcfg.with_overrides(remat=remat),
                                    r.topt)
        out.append(step(tp, ts, b, 0))
    assert float(out[0][2]["loss"]) == float(out[1][2]["loss"])
    _assert_tree_close(out[1][0], jax.tree.map(
        lambda t: t.numpy(), out[0][0]), atol=1e-7, rtol=1e-7)


def test_train_step_with_use_flash_raises():
    with pytest.raises(NotImplementedError, match="backward kernel"):
        tapi.make_train_step(_tcfg(use_flash=True), topt.adamw(1e-3))


# ---------------------------------------------------- trainer and CLI
TINY = dict(name="tiny", arch_type="dense", num_layers=2, d_model=64,
            num_heads=2, num_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=128, dtype="float32")


def test_trainer_loss_decreases():
    """tests/test_system.py's tiny config on the port's own data (copy_prob
    0.9): the loss drops at least 20 % in 24 steps."""
    trainer = Trainer(ArchConfig(**TINY), topt.adamw(1e-2),
                      TrainerConfig(steps=24, log_every=8))
    data = tpipe.lm_batches(torch.Generator().manual_seed(1),
                            vocab_size=128, batch=8, seq_len=64,
                            copy_prob=0.9, device="cpu")
    _, _, history = trainer.run(torch.Generator().manual_seed(0), data)
    assert [h["step"] for h in history] == [0, 8, 16, 23]
    assert history[-1]["loss"] < 0.8 * history[0]["loss"], history


def test_trainer_checkpoints_and_refuses_a_mesh(tmp_path):
    cfg = ArchConfig(**TINY)
    trainer = Trainer(cfg, topt.adamw(1e-3), TrainerConfig(
        steps=5, log_every=5, ckpt_every=2, ckpt_dir=str(tmp_path)))
    data = tpipe.lm_batches(torch.Generator().manual_seed(1),
                            vocab_size=128, batch=2, seq_len=16,
                            device="cpu")
    params, opt_state, _ = trainer.run(torch.Generator().manual_seed(0), data)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_00000002.npz", "ckpt_00000004.npz", "latest.json"]
    restored, step = tckpt.restore(str(tmp_path),
                                   {"params": params, "opt": opt_state})
    assert step == 4
    assert all(torch.equal(a, b) for a, b in zip(
        topt.tree_leaves(restored), topt.tree_leaves(
            {"params": params, "opt": opt_state})))
    # a mesh with a model axis above 1 (tensor parallelism; its runs:
    # tests/test_torch_tp.py) and a data-parallel mesh (its runs:
    # tests/test_torch_trainer_dp.py) are taken, in_shardings only with a
    # mesh
    from repro_torch.sharding.context import AbstractMesh
    Trainer(cfg, topt.adamw(1e-3),
            mesh=AbstractMesh((2, 2), ("data", "model")))
    Trainer(cfg, topt.adamw(1e-3), mesh=AbstractMesh((4, 1),
                                                     ("data", "model")))
    with pytest.raises(ValueError, match="in_shardings needs a mesh"):
        Trainer(cfg, topt.adamw(1e-3), in_shardings={})
    with pytest.raises(ValueError, match="ckpt_dir"):
        Trainer(cfg, topt.adamw(1e-3), TrainerConfig(ckpt_every=2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_the_packages(tmp_path, dtype):
    """A port checkpoint restores in the reference's ``restore`` and a
    reference checkpoint in the port's, leaf for leaf, bit for bit (bf16
    leaves go through float32 one way and 2-byte voids the other)."""
    jcfg, tcfg = _jcfg(dtype=dtype), _tcfg(dtype=dtype)
    jparams = japi.init_params(jax.random.key(0), jcfg)
    opt = jopt.adamw(1e-3)
    jtree = {"params": jparams, "opt": opt.init(jparams)}
    ttree = {"params": model_params_from_numpy(tcfg, _np(jparams),
                                               device="cpu")}
    ttree["opt"] = topt.adamw(1e-3).init(ttree["params"])
    # the port's moments, made non-zero
    ttree["opt"]["m"] = topt.tree_map(lambda p: p * 0.5, ttree["params"])
    tckpt.save(str(tmp_path / "port"), 7, ttree)
    got, step = jckpt.restore(str(tmp_path / "port"), jtree)
    assert step == 7
    _assert_bits(ttree, got)
    jtree["opt"] = {"m": jax.tree.map(lambda p: p * 0.5, jparams),
                    "v": jtree["opt"]["v"]}
    jckpt.save(str(tmp_path / "ref"), 9, jtree)
    template = {"params": tapi.init_params(tcfg, torch.Generator()
                                           .manual_seed(5)),
                "opt": topt.adamw(1e-3).init(ttree["params"])}
    back, step = tckpt.restore(str(tmp_path / "ref"), template)
    assert step == 9
    _assert_bits(back, jtree)


def _assert_bits(port_tree, ref_tree):
    got, want = _flat(port_tree), _flat(_np(ref_tree))
    assert set(got) == set(want)
    for k, a in got.items():
        b = np.asarray(want[k])
        assert str(a.dtype).removeprefix("torch.") == b.dtype.name, k
        np.testing.assert_array_equal(a.float().numpy(),
                                      b.astype(np.float32), err_msg=k)


def test_train_cli_on_cpu(capsys):
    ttrain.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                 "--steps", "3", "--batch", "2", "--seq", "32"])
    lines = capsys.readouterr().out.strip().splitlines()
    cfg = TARCHS[ARCH].reduced()
    n = tapi.count_params(tapi.init_params(cfg))
    assert lines[0] == (f"arch=qwen3-0.6b params={n:,} steps=3 batch=2 "
                        f"seq=32")
    assert [ln.split()[:2] for ln in lines[1:4]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert all(" loss " in ln and " wall " in ln for ln in lines[1:4])
    assert lines[4].startswith("loss: ") and "improved" in lines[4]
    assert lines[5].startswith("step time: ") and "on cpu" in lines[5]
    assert lines[6].startswith("tokens/s: ")
    assert len(lines) == 7          # no device memory line on the CPU


def test_train_cli_preset_and_launch_counts():
    """The 100m preset is the reference's; on the CPU the kernels' launch
    counts stay 0 (plain versions)."""
    from repro.launch.train import PRESETS as JPRESETS
    assert ttrain.PRESETS["100m"].__dict__ == JPRESETS["100m"].__dict__
    before = (twce.weighted_ce_fwd.launches, twce.weighted_ce_bwd.launches)
    run = ttrain.run(ttrain.parser().parse_args(
        ["--device", "cpu", "--reduced", "--steps", "2", "--batch", "1",
         "--seq", "8"]))
    assert len(run.step_s) == 2 and run.peak_bytes is None
    assert (twce.weighted_ce_fwd.launches,
            twce.weighted_ce_bwd.launches) == before


def test_train_cli_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--reduced", "--steps", "1"])


def test_init_cache_defaults_to_the_card():
    """The decode cache is made on the card unless the caller asks for the
    CPU (an entry point never drops to the CPU on its own)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.init_cache(_tcfg(), 2, 8)
    assert tapi.init_cache(_tcfg(), 2, 8, device="cpu")["sub0"].k.is_cpu


# ------------------------------------------------------------- on card
@pytest.mark.gpu
def test_qwen3_train_step_tracks_reference_on_card():
    """qwen3-0.6b at full width (d 1024, 16/8 heads of 128, d_ff 3072,
    vocab 151936) cut to 2 layers, float32, B 2, S 64: the loss and the
    parameter gradients on the card (weighted-CE kernels) against the
    reference's on the host, then one port train step (skips without a
    card).  Tolerance: loss rtol 1e-4, global gradient norm rtol 1e-3
    (float32 on both sides, TF32 off; cuBLAS against XLA's CPU dot)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    jcfg = JARCHS[ARCH].with_overrides(num_layers=2, dtype="float32")
    tcfg = TARCHS[ARCH].with_overrides(num_layers=2, dtype="float32")
    jparams = japi.init_params(jax.random.key(0), jcfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 64)
                                    ).astype(np.int32),
             "sample_weight": np.asarray([0.5, 1.5], np.float32)}

    def jloss(p):
        logits, _, _ = japi.forward(p, {"tokens": batch["tokens"]}, jcfg)
        return japi.weighted_next_token_loss(
            logits, jax.tree.map(jnp.asarray, batch), jcfg)

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = model_params_from_numpy(tcfg, _np(jparams), device="cuda")
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    leaves = [p.requires_grad_(True) for p in topt.tree_leaves(params)]
    fwd0 = twce.weighted_ce_fwd.launches
    logits, _ = ttransformer.forward_train(params, tb, tcfg)
    loss = tapi.weighted_next_token_loss(logits, tb, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert twce.weighted_ce_fwd.launches == fwd0 + 1
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    norm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads)))
    np.testing.assert_allclose(norm, float(jopt.global_norm(jgrads)),
                               rtol=1e-3)
    opt = topt.adamw(1e-3, grad_clip_norm=1.0)
    step = tapi.make_train_step(tcfg, opt)
    plain = topt.tree_map(lambda p: p.detach(), params)
    _, _, m = step(plain, opt.init(plain), tb, 0)
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-4)

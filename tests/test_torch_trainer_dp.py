"""The data-parallel ``Trainer(mesh=)`` on a 4-rank gloo world (data 4)
against the JAX package's ``Trainer`` on one device over the global
batch.

Reduced qwen3-0.6b and granite-moe-1b-a400m (``reduced()``: 2 layers,
narrow; float32), the reference's init carried across, three global
batches of 8 sequences of 16 tokens with non-uniform sample weights.
Each rank takes 2 rows of each batch; the loss normalizer, the MoE
router's statistics and the gradients are all-reduced.

  * Momentum SGD, 3 steps: every step's loss and aux and the final
    parameters within atol 1e-5 + rtol 1e-5 of the reference's (the
    gradients are the four shards' sums, where the reference sums one
    batch: ROADMAP Queue 3, as tests/test_torch_moe.py holds SGD steps).
  * AdamW, 1 step: its loss and aux within rtol 1e-5 (AdamW's normalized
    step turns an ulp of a near-zero gradient into a step of the learning
    rate, ROADMAP Queue 3).
  * With 2 microbatches (each rank's rows of each), the data-parallel
    steps equal the port's one-device trainer's within the same
    tolerance.
  * Expert parallel (``ep_a2a``, one expert a rank) steps equal the
    grouped path's data-parallel steps, and the checkpoint the ep_a2a
    run writes holds the full parameters and momenta (gathered from the
    ranks' expert slices), equal to the grouped run's.
  * On a (pod 2, data 2) mesh, ep_a2a (two experts a rank, the banks
    copied across pods) with the aux loss in the objective equals the
    (data 4) ep_a2a run: the same four shards' losses, the banks'
    gradients summed across pods.
  * A global batch of 6, which 4 ranks do not divide, is replicated as
    its spec says: every rank's steps equal the one-device trainer's.
  * A mesh with a model axis of 2 is taken (tensor parallelism: its runs
    are tests/test_torch_tp.py's).
"""
import numpy as np
import pytest
import torch

from torch_dist_common import spawn_world

ARCHS = ["qwen3-0.6b", "granite-moe-1b-a400m"]
WORLD, B, S, STEPS = 4, 8, 16, 3
TOL = dict(atol=1e-5, rtol=1e-5)


def _batches(cfg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32),
             "sample_weight": rng.uniform(0.2, 2.0, B).astype(np.float32)}
            for _ in range(STEPS)]


def _start(arch: str) -> dict:
    """The reference's init and the global batches, numpy."""
    import jax
    from repro.configs.registry import ARCHS as JARCHS
    from repro.models import api as japi
    cfg = JARCHS[arch].reduced().with_overrides(dtype="float32")
    return {"params0": jax.tree.map(
        np.asarray, japi.init_params(jax.random.key(0), cfg)),
        "batches": _batches(cfg, 1)}


def _reference(arch: str, start: dict) -> dict:
    """The reference's Trainer runs from ``start`` (SGD 3 steps, AdamW 1
    step), numpy."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import ARCHS as JARCHS
    from repro.optim import optimizers as jopt
    from repro.train.trainer import Trainer, TrainerConfig
    cfg = JARCHS[arch].reduced().with_overrides(dtype="float32")
    params = jax.tree.map(jnp.asarray, start["params0"])
    batches = start["batches"]
    out = dict(start)
    for name, opt, steps in (("sgd", jopt.sgd(0.1, momentum=0.9), STEPS),
                             ("adamw", jopt.adamw(1e-3), 1)):
        trainer = Trainer(cfg, opt, TrainerConfig(steps=steps, log_every=1))
        p, _, hist = trainer.run(
            None, iter([jax.tree.map(jnp.asarray, b) for b in batches]),
            params=params, opt_state=opt.init(params))
        out[name] = (jax.tree.map(np.asarray, p),
                     [(h["loss"], h["aux_loss"]) for h in hist])
    return out


def _run(trainer, params, batches):
    """The trainer's run from ``params`` (its ``shard_params``) on
    ``batches``; returns (full params, full optimizer state, [(loss,
    aux)])."""
    params = trainer.shard_params(params)
    opt = trainer.optimizer
    p, state, hist = trainer.run(None, iter(batches), params=params,
                                 opt_state=opt.init(params))
    return (trainer.gather_params(p),
            {k: trainer.gather_params(v) for k, v in state.items()},
            [(h["loss"], h["aux_loss"]) for h in hist])


def dp_rank(rank, world, refs, ckpt):
    from repro_torch.configs.registry import ARCHS as TARCHS
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.optim import optimizers as topt
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import make_mesh
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.configs.base import InputShape
    mesh = make_mesh((WORLD,), ("data",), "cpu")
    out = {}
    for arch, ref in refs.items():
        cfg = TARCHS[arch].reduced().with_overrides(dtype="float32")
        batches = [{k: torch.tensor(v) for k, v in b.items()}
                   for b in ref["batches"]]
        spec = rules.batch_spec(cfg, InputShape("train", S, B, "train"),
                                mesh)
        for name, opt, steps, m in (
                ("sgd", topt.sgd(0.1, momentum=0.9), STEPS, 1),
                ("adamw", topt.adamw(1e-3), 1, 1),
                ("micro", topt.sgd(0.1, momentum=0.9), STEPS, 2)):
            c = cfg.with_overrides(microbatches=m)
            params = model_params_from_numpy(c, ref["params0"], device="cpu")
            trainer = Trainer(c, opt, TrainerConfig(steps=steps, log_every=1),
                              mesh=mesh, in_shardings=spec)
            p, _, hist = trainer.run(None, iter(batches), params=params,
                                     opt_state=opt.init(params))
            out[(arch, name)] = (p, [(h["loss"], h["aux_loss"])
                                     for h in hist])
        if cfg.is_moe:          # expert parallel against the grouped path
            pod = make_mesh((2, 2), ("pod", "data"), "cpu")
            for name, impl, coef, on in (
                    ("ep_a2a", "ep_a2a", 0.0, mesh),
                    ("gmm", "gmm", 0.0, mesh),
                    ("ep_aux", "ep_a2a", None, mesh),
                    ("ep_pod", "ep_a2a", None, pod)):
                c = cfg.with_overrides(moe_impl=impl)
                if coef is not None:
                    c = c.with_overrides(router_aux_coef=coef)
                tcfg = TrainerConfig(steps=STEPS, log_every=1)
                if name == "ep_a2a":
                    tcfg = TrainerConfig(steps=STEPS, log_every=1,
                                         ckpt_every=STEPS - 1,
                                         ckpt_dir=ckpt)
                out[(arch, name)] = _run(
                    Trainer(c, topt.sgd(0.1, momentum=0.9), tcfg, mesh=on),
                    model_params_from_numpy(c, ref["params0"], device="cpu"),
                    batches)
        else:                   # a batch the ranks do not divide
            c = cfg.with_overrides(microbatches=1)
            out[(arch, "b6")] = _run(
                Trainer(c, topt.sgd(0.1, momentum=0.9),
                        TrainerConfig(steps=STEPS, log_every=1), mesh=mesh),
                model_params_from_numpy(c, ref["params0"], device="cpu"),
                [{k: v[:6] for k, v in b.items()} for b in batches])
    try:
        Trainer(cfg, topt.sgd(0.1), mesh=make_mesh((2, 2), ("data", "model"),
                                                   "cpu"))
        out["tp"] = "ran"
    except NotImplementedError as e:
        out["tp"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world runs beside the reference's trainers (a thread waits on
    it)."""
    from concurrent.futures import ThreadPoolExecutor
    starts = {arch: _start(arch) for arch in ARCHS}
    with ThreadPoolExecutor(1) as pool:
        ckpt = tmp_path_factory.mktemp("ckpt")
        world = pool.submit(spawn_world, "test_torch_trainer_dp:dp_rank",
                            WORLD, tmp_path_factory.mktemp("dp"),
                            {"refs": starts, "ckpt": str(ckpt)})
        refs = {arch: _reference(arch, starts[arch]) for arch in ARCHS}
        refs["ckpt"] = str(ckpt)
        return refs, world.result()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, x in tree.items()
                for p, v in _flat(x, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_sgd_steps_match_the_reference_trainer(runs, arch):
    refs, ranks = runs
    want_params, want_hist = refs[arch]["sgd"]
    for out in ranks:
        params, hist = out[(arch, "sgd")]
        assert len(hist) == STEPS
        np.testing.assert_allclose(np.asarray(hist), np.asarray(want_hist),
                                   **TOL)
        got, want = _flat(params), _flat(want_params)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k,
                                       **TOL)
    moe = arch.startswith("granite")
    assert (want_hist[0][1] > 0) == moe


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_loss_and_aux_match(runs, arch):
    refs, ranks = runs
    want = refs[arch]["adamw"][1]
    for out in ranks:
        np.testing.assert_allclose(np.asarray(out[(arch, "adamw")][1]),
                                   np.asarray(want), rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_compose_with_data_parallel(runs, arch):
    """The data-parallel run with 2 microbatches against the port's
    one-device trainer with 2 microbatches on the global batches."""
    from repro_torch.configs.registry import ARCHS as TARCHS
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.optim import optimizers as topt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    refs, ranks = runs
    cfg = TARCHS[arch].reduced().with_overrides(dtype="float32",
                                                microbatches=2)
    params = model_params_from_numpy(cfg, refs[arch]["params0"],
                                     device="cpu")
    opt = topt.sgd(0.1, momentum=0.9)
    p, _, hist = Trainer(cfg, opt, TrainerConfig(steps=STEPS, log_every=1)
                         ).run(None, iter([{k: torch.tensor(v)
                                            for k, v in b.items()}
                                           for b in refs[arch]["batches"]]),
                               params=params, opt_state=opt.init(params))
    want = _flat(p)
    for out in ranks:
        got_p, got_hist = out[(arch, "micro")]
        np.testing.assert_allclose(np.asarray(got_hist),
                                   np.asarray([(h["loss"], h["aux_loss"])
                                               for h in hist]), **TOL)
        got = _flat(got_p)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=k, **TOL)


def test_expert_parallel_steps_equal_the_grouped_ones(runs):
    """granite's experts (4) one a rank under ep_a2a (capacity 128 of 64
    copies: none dropped), the aux loss out of the objective (the EP's is
    the shards' mean, the grouped path's the global batch's): the losses,
    the parameters and the momenta (each rank's expert slices gathered)
    within the tolerance above of the grouped data-parallel run's; the
    checkpoint of the last step, written by rank 0, holds the same full
    trees."""
    from repro_torch.train import checkpoint as ckpt_lib
    refs, ranks = runs
    arch = "granite-moe-1b-a400m"
    for out in ranks:
        (ep_p, ep_s, ep_hist), (g_p, g_s, g_hist) = out[(arch, "ep_a2a")], \
            out[(arch, "gmm")]
        np.testing.assert_allclose(np.asarray(ep_hist)[:, 0],
                                   np.asarray(g_hist)[:, 0], **TOL)
        _assert_trees_close({"params": ep_p, "opt": ep_s},
                            {"params": g_p, "opt": g_s})
    want = {"params": g_p, "opt": g_s}
    saved, step = ckpt_lib.restore(refs["ckpt"], want)
    assert step == STEPS - 1
    _assert_trees_close(saved, want)


def test_expert_parallel_over_pods_equals_one_data_axis(runs):
    """ep_a2a on (pod 2, data 2), two experts a rank and the banks copied
    across the pods, with the aux loss in the objective, against ep_a2a
    on (data 4): each takes the mean of the same four shards' router
    losses, so the losses, aux and full parameters are within the
    tolerance above, and every rank ends with the same full trees."""
    arch = "granite-moe-1b-a400m"
    for out in runs[1]:
        (pod_p, pod_s, pod_hist), (d_p, d_s, d_hist) = \
            out[(arch, "ep_pod")], out[(arch, "ep_aux")]
        assert np.asarray(d_hist)[:, 1].min() > 0
        np.testing.assert_allclose(np.asarray(pod_hist), np.asarray(d_hist),
                                   **TOL)
        _assert_trees_close({"params": pod_p, "opt": pod_s},
                            {"params": d_p, "opt": d_s})
        _assert_trees_close(pod_p, runs[1][0][(arch, "ep_pod")][0])


def test_a_batch_the_ranks_do_not_divide_runs_whole(runs):
    """qwen3 on global batches of 6 over 4 ranks: the batch spec
    replicates it, and every rank's steps equal the port's one-device
    trainer's on the same batches within the tolerance above."""
    from repro_torch.configs.registry import ARCHS as TARCHS
    from repro_torch.convert import model_params_from_numpy
    from repro_torch.optim import optimizers as topt
    from repro_torch.train.trainer import Trainer, TrainerConfig
    refs, ranks = runs
    arch = "qwen3-0.6b"
    cfg = TARCHS[arch].reduced().with_overrides(dtype="float32")
    params = model_params_from_numpy(cfg, refs[arch]["params0"],
                                     device="cpu")
    opt = topt.sgd(0.1, momentum=0.9)
    p, state, hist = Trainer(cfg, opt, TrainerConfig(steps=STEPS,
                                                     log_every=1)).run(
        None, iter([{k: torch.tensor(v[:6]) for k, v in b.items()}
                    for b in refs[arch]["batches"]]),
        params=params, opt_state=opt.init(params))
    for out in ranks:
        got_p, got_s, got_hist = out[(arch, "b6")]
        np.testing.assert_allclose(np.asarray(got_hist),
                                   np.asarray([(h["loss"], h["aux_loss"])
                                               for h in hist]), **TOL)
        _assert_trees_close({"params": got_p, "opt": got_s},
                            {"params": p, "opt": state})


def _assert_trees_close(got: dict, want: dict) -> None:
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **TOL)


def test_a_model_axis_raises(runs):
    """It raised until tensor parallelism was ported; the trainer now takes
    a (data 2, model 2) mesh on every rank."""
    for out in runs[1]:
        assert out["tp"] == "ran"

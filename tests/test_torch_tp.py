"""Tensor parallelism over ``model`` (``sharding/tp.py``) on one 8-rank
gloo world shaped (data 2, model 4), against the JAX package's
``jax.jit(step, in_shardings=rules.named(mesh, pspecs))`` on a (2, 4) mesh
of 8 host devices under ``mesh_context``: the reference's GSPMD program
and the port's Megatron collectives on the same numpy params.

The configs keep ``rules.use_tp`` (d_model 1024) and are cut to 2 layers,
d_ff 2048, vocab 4096, float32, B 4, S 16, H 8: dense GQA with KV 4 (the
KV projections and the decode cache split over heads) and KV 2 (both
whole, the cache split along its positions), granite's MoE (4 experts, ff
split), jamba's SSM + attention pair (MoE every second layer),
minicpm3's MLA over whole heads, and at H 6 (which 4 does not divide)
with ``mla_rank_shard`` (the b-matrices split on their rank dim), each
with ``seq_parallel`` off and on, against the reference's program
without it (its ``seq_parallel`` only constrains GSPMD's shardings: the
same arithmetic).  Each rank:

  * holds every leaf ``param_specs`` splits over ``model`` split (its
    local shape is the rule's shard);
  * prefill: the last position's logits within atol 1e-5 + rtol 1e-5;
  * 4 decode steps (teacher-forced tokens) from the prefill's cache,
    padded to 24 and laid out by ``rules.cache_specs``: logits as above;
  * one ``Trainer(mesh=)`` SGD step (lr 0.5): its loss and aux (rtol
    1e-5); the gradients its step hands the optimizer (summed over
    ``data``) within 1e-4 of max|g| of the reference's
    ``jax.value_and_grad`` of the train step's loss (each rank's shards
    against the reference's cut by ``rules.shard_index``: together the
    gathered gradient); and its params, gathered from the ranks' shards
    (as a checkpoint gathers them), within atol 1e-5 + rtol 1e-5 of the
    reference ``sgd`` rule (p - lr g, float32) on the reference's
    gradients.

internvl2-2b's vision stub (8 patch embeddings prepended, replicated)
runs the same way, against the port's own mesh-less prefill on every
rank (the reference's vision path is held by tests/test_torch_zoo.py).

The reference writes each run's gradients as ``.npy`` files as soon as it
has them; each rank compares its shards there (memory-mapped) and returns
only the errors, so no process holds every run's full gradients.

The tolerances are the data-parallel tests': float32 sums in another
order (GSPMD's partial sums against the port's all-reduces) part at ~1e-6
of a logit.
"""
import time
from pathlib import Path

import numpy as np
import pytest

from torch_dist_common import JaxReference, spawn_world

DATA, MODEL = 2, 4
B, S, S_CACHE, STEPS, LR = 4, 16, 24, 4, 0.5
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4
# the world waits on the reference's gradients; under a full suite's load
# both run ~3x slower than alone (~40 s)
WORLD_DEADLINE = 300.0

BASE = dict(d_model=1024, num_layers=2, d_ff=2048, vocab_size=4096,
            num_heads=8, head_dim=64, dtype="float32")
CONFIGS = {
    "kv4": ("qwen3-0.6b", dict(num_kv_heads=4)),
    "kv2": ("qwen3-0.6b", dict(num_kv_heads=2)),
    "moe": ("granite-moe-1b-a400m", dict(num_kv_heads=4)),
    "jamba": ("jamba-v0.1-52b", dict(num_kv_heads=4,
                                     layer_pattern=("ssm", "attn"),
                                     moe_every=2)),
    "mla": ("minicpm3-4b", dict(num_kv_heads=8)),
    "mla_rank": ("minicpm3-4b", dict(num_heads=6, num_kv_heads=6,
                                     mla_rank_shard=True)),
}
RUNS = [(name, sp) for name in CONFIGS for sp in (False, True)]
# The reference's seq_parallel adds sharding constraints only (its
# ``_seq_shard``), not arithmetic, so the port's runs with seq_parallel
# on and off are both held against its program without it (the test's
# time: every reference program is a compile).


def ref_tag(name: str, sp: bool) -> str:
    """The reference run a port run is held against."""
    return f"{name}_0"


def config(archs: dict, name: str, sp: bool):
    """The reduced config of ``name`` from a registry (the port's or the
    reference's: the same fields)."""
    arch, kw = CONFIGS[name]
    return archs[arch].reduced().with_overrides(**{**BASE, **kw},
                                                seq_parallel=sp)


def np_params(shapes, seed: int) -> dict:
    """Params of a tree of shapes, drawn with numpy in sorted key order:
    1/sqrt(fan in) for matrices, 0.02 for the embeddings, norms near 1,
    the SSM's A_log = log(1..H) and dt_bias in [-4, -2]."""
    rng = np.random.default_rng(seed)

    def leaf(name: str, shape: tuple) -> np.ndarray:
        if name == "A_log":
            h = shape[-1]
            return np.broadcast_to(np.log(np.arange(1, h + 1)), shape)
        if name == "dt_bias":
            return rng.uniform(-4, -2, shape)
        if name in ("scale", "D"):
            return 1 + 0.1 * rng.standard_normal(shape)
        if name.endswith("bias"):
            return 0.02 * rng.standard_normal(shape)
        if name in ("embedding", "unembedding"):
            return 0.02 * rng.standard_normal(shape)
        if name.startswith("conv"):
            return 0.5 * rng.standard_normal(shape)
        return rng.standard_normal(shape) / np.sqrt(shape[-2])

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        return np.ascontiguousarray(leaf(name, tuple(node)),
                                    dtype=np.float32)
    return walk(shapes)


def save_params(params: dict, directory: Path) -> None:
    """One ``.npy`` a leaf, named by its path with dots, then a marker
    that the tree is whole."""
    directory.mkdir(parents=True)
    for key, leaf in _flat(params).items():
        np.save(directory / f"{key.replace('/', '.')}.npy", leaf)
    directory.with_suffix(".done").touch()


def load_params(directory: Path) -> dict:
    """:func:`save_params`'s tree, once it is whole, each leaf
    memory-mapped (the world's ranks and the reference read one copy of
    the file)."""
    done, end = Path(directory).with_suffix(".done"), time.monotonic() + 60
    while not done.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"no params in {directory}")
        time.sleep(0.1)
    tree: dict = {}
    for f in sorted(Path(directory).glob("*.npy")):
        *path, leaf = f.stem.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.load(f, mmap_mode="r")
    return tree


def inputs(seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, BASE["vocab_size"], (B, S)
                                   ).astype(np.int32),
            "decode": rng.integers(0, BASE["vocab_size"], (B, STEPS)
                                   ).astype(np.int32),
            "sample_weight": rng.uniform(0.2, 2.0, B).astype(np.float32)}


_JAX = """
import os, sys
from pathlib import Path
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import ARCHS
from repro.models import api
from repro.optim.optimizers import sgd
from repro.sharding import rules
from repro.sharding.context import mesh_context
from test_torch_tp import (B, LR, RUNS, S, S_CACHE, STEPS, config,
                           inputs, load_params)

data = inputs()
grads_dir = Path(os.environ["OUT"]).parent / "grads"
params_dir = Path(os.environ["OUT"]).parent.parent / "params"
# GSPMD's automatic axes: the reference was written for them (JAX 0.4's
# make_mesh); JAX 0.9's default explicit axes refuse its decode update
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
repl = NamedSharding(mesh, P())
out = {}
for name, sp in [run for run in RUNS if not run[1]]:
    cfg = config(ARCHS, name, sp)
    tag = f"{name}_{int(sp)}/"
    params = jax.tree.map(jnp.asarray, load_params(params_dir / name),
                          is_leaf=lambda x: isinstance(x, np.ndarray))
    pspecs = rules.named(mesh, rules.param_specs(params, cfg, mesh))
    bsh = NamedSharding(mesh, P("data", None))
    wsh = NamedSharding(mesh, P("data"))
    batch = {"tokens": jnp.asarray(data["tokens"]),
             "sample_weight": jnp.asarray(data["sample_weight"])}

    def loss_fn(p, mb):
        # the train step's loss; its forward is the prefill step's too
        logits, caches, aux = api.forward(p, mb, cfg)
        loss = api.weighted_next_token_loss(logits, mb, cfg)
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux
        return loss, (aux, logits[:, -1:, :], caches)
    with mesh, mesh_context(mesh):
        (loss, (aux, logits, caches)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True), in_shardings=(
                pspecs, {"tokens": bsh, "sample_weight": wsh}))(params,
                                                                batch)
        out[tag + "prefill"] = np.asarray(logits)
        caches = api.pad_prefill_cache(caches, cfg, S_CACHE)
        cspecs = rules.named(mesh, rules.cache_spec_tree(
            caches, cfg, mesh, B, S_CACHE))
        caches = jax.device_put(caches, cspecs)
        serve = jax.jit(api.make_serve_step(cfg), in_shardings=(
            pspecs, cspecs, bsh, repl))
        for i in range(STEPS):
            tok = jnp.asarray(data["decode"][:, i:i + 1])
            _, logits, caches = serve(params, caches, tok,
                                      jnp.int32(S + i))
            out[tag + f"decode{i}"] = np.asarray(logits)
    out[tag + "loss"] = np.asarray([loss, aux])
    run_dir = grads_dir / f"{name}_{int(sp)}"
    run_dir.mkdir(parents=True)
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        key = "/".join(str(p.key) for p in path)
        np.save(run_dir / (key.replace("/", ".") + ".npy"), np.asarray(g))
    (grads_dir / f"{name}_{int(sp)}.done").touch()
np.savez(os.environ["OUT"], **out)
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, x in tree.items()
                for p, v in _flat(x, f"{prefix}/{k}" if prefix else k
                                  ).items()}
    return {prefix: tree}


def _compare(grads_dir: Path, tag: str, mesh, full: dict, specs: dict,
             grads: dict, new: dict) -> dict:
    """Once the reference has written this run's gradients: per leaf,
    (max |g - g_ref|, max |g_ref|) of this rank's shard and max |p -
    p_ref| - rtol |p_ref| of the gathered params, p_ref = p0 - lr g_ref
    in float32."""
    from repro_torch.sharding import rules
    done = grads_dir / f"{tag}.done"
    end = time.monotonic() + WORLD_DEADLINE
    while not done.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"no reference gradients for {tag}")
        time.sleep(0.2)
    p0 = _flat(full)
    errors = {}
    for k, g in grads.items():
        ref = np.load(grads_dir / tag / (k.replace("/", ".") + ".npy"),
                      mmap_mode="r")
        want = np.asarray(ref[rules.shard_index(mesh, specs[k], ref.shape,
                                                mesh)])
        p_ref = p0[k] - np.float32(LR) * np.asarray(ref)
        errors[k] = (float(np.abs(g.numpy() - want).max()),
                     float(np.abs(ref).max()),
                     float((np.abs(new[k].numpy() - p_ref)
                            - TOL["rtol"] * np.abs(p_ref)).max()))
    return errors


def tp_rank(rank, world, data, grads_dir, params_dir):
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.convert import (local_shards_from_numpy,
                                     model_params_from_numpy)
    from repro_torch.models import api
    from repro_torch.optim import optimizers as topt
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import make_mesh, mesh_context
    from repro_torch.train.trainer import Trainer, TrainerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((DATA, MODEL), ("data", "model"), "cpu")
    d = mesh.coordinate("data")
    rows = slice(d * B // DATA, (d + 1) * B // DATA)
    tokens = torch.tensor(data["tokens"])
    weight = torch.tensor(data["sample_weight"])
    out = {}
    for name, sp in RUNS:
        cfg = config(ARCHS, name, sp)
        tag = f"{name}_{int(sp)}/"
        full = load_params(Path(params_dir) / name)
        specs = rules.held_specs(cfg, mesh)
        params = local_shards_from_numpy(full, specs, mesh, device="cpu")
        out[tag + "shapes"] = {k: tuple(v.shape)
                               for k, v in _flat(params).items()}
        with torch.no_grad(), mesh_context(mesh):
            logits, caches = api.make_prefill_step(cfg)(
                params, {"tokens": tokens[rows]})
            out[tag + "prefill"] = logits
            caches = api.pad_prefill_cache(caches, cfg, S_CACHE, batch=B)
            serve = api.make_serve_step(cfg)
            for i in range(STEPS):
                tok = torch.tensor(data["decode"][rows, i:i + 1])
                _, logits, caches = serve(params, caches, tok, S + i)
                out[tag + f"decode{i}"] = logits
        seen, sgd = {}, topt.sgd(LR)

        def update(grads, state, p, step):    # SGD, keeping the gradients
            seen["grads"] = grads               # the step hands it, summed
            return sgd.update(grads, state, p, step)
        trainer = Trainer(cfg, topt.Optimizer(sgd.init, update),
                          TrainerConfig(steps=1), mesh=mesh)
        new, _, hist = trainer.run(
            None, iter([{"tokens": tokens, "sample_weight": weight}]),
            params=params, opt_state=sgd.init(params))
        grads = seen["grads"]
        out[tag + "loss"] = (hist[0]["loss"], hist[0]["aux_loss"])
        out[tag + "errors"] = _compare(
            Path(grads_dir), ref_tag(name, sp), mesh, full, _flat(specs),
            _flat(grads), _flat(trainer.gather_params(new)))
        if (name, sp) == ("kv4", False):
            # a batch of 3 that data 2 does not divide: every data rank
            # steps on all of it (the model group's ranks still split)
            b3 = {"tokens": tokens[:3], "sample_weight": weight[:3]}
            whole = model_params_from_numpy(cfg, full, device="cpu")
            runs = [Trainer(cfg, topt.sgd(LR), TrainerConfig(steps=1),
                            mesh=m).run(None, iter([b3]), params=p,
                                        opt_state=topt.sgd(LR).init(p))[0]
                    for m, p in ((mesh, params), (None, whole))]
            got = _flat(trainer.gather_params(runs[0]))
            out["b3"] = max(float((got[k] - v).abs().max())
                            for k, v in _flat(runs[1]).items())
    for sp in (False, True):            # the vision stub, port against port
        cfg = config(ARCHS, "kv4", sp).with_overrides(
            name="internvl2-2b", arch_type="vlm", frontend="vision",
            num_frontend_tokens=8)
        full = load_params(Path(params_dir) / "kv4")   # the same tree
        params = local_shards_from_numpy(full, rules.held_specs(cfg, mesh),
                                         mesh, device="cpu")
        patch = torch.tensor(np.random.default_rng(3).standard_normal(
            (B, 8, BASE["d_model"])).astype(np.float32))
        batch = {"tokens": tokens[rows], "patch_emb": patch[rows]}
        with torch.no_grad():
            want, _ = api.make_prefill_step(cfg)(
                model_params_from_numpy(cfg, full, device="cpu"), batch)
            with mesh_context(mesh):
                got, _ = api.make_prefill_step(cfg)(params, batch)
        out[f"vlm_{int(sp)}"] = (got, want)
    # a ring cache of 8 (window 8, KV 2: split along its positions),
    # 12 steps from empty, port against port
    cfg = config(ARCHS, "kv2", False).with_overrides(window=8)
    full = load_params(Path(params_dir) / "kv2")       # the same tree
    steps = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 12))
    ring = []
    for m, p, batch in ((mesh, local_shards_from_numpy(
            full, rules.held_specs(cfg, mesh), mesh, device="cpu"), B),
            (None, model_params_from_numpy(cfg, full, device="cpu"),
             B // DATA)):
        with torch.no_grad(), mesh_context(m):
            caches = api.init_cache(cfg, batch, 8, device="cpu")
            serve = api.make_serve_step(cfg, "ring")
            ring.append([serve(p, caches, torch.tensor(
                steps[rows, i:i + 1], dtype=torch.int32), i)[1]
                for i in range(12)])
    out["ring"] = max(float((a - b).abs().max()) for a, b in zip(*ring))
    # the kv_quant serving order (pad_prefill_cache, then quantize_cache)
    # on the mesh-less prefill's cache (KV 2: split along its positions,
    # over model at batch B and over (data, model) at batch 1), 4 steps,
    # port against port
    cfg = config(ARCHS, "kv2", False).with_overrides(kv_quant=True)
    whole = model_params_from_numpy(cfg, full, device="cpu")
    held = local_shards_from_numpy(full, rules.held_specs(cfg, mesh), mesh,
                                   device="cpu")
    for batch, mine in ((B, rows), (1, slice(0, 1))):
        got = []
        with torch.no_grad():
            _, prompt = api.make_prefill_step(cfg)(
                whole, {"tokens": tokens[mine]})
            for m, p in ((mesh, held), (None, whole)):
                with mesh_context(m):
                    caches = api.quantize_cache(api.pad_prefill_cache(
                        prompt, cfg, S_CACHE, batch=batch), cfg)
                    serve = api.make_serve_step(cfg)
                    got.append([serve(p, caches, torch.tensor(
                        data["decode"][mine, i:i + 1]), S + i)[1]
                        for i in range(STEPS)])
        out[f"quant_b{batch}"] = max(float((a - b).abs().max())
                                     for a, b in zip(*got))
    out["coord"] = {"data": d, "model": mesh.coordinate("model")}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import shutil
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import api
    from repro_torch.optim.optimizers import tree_map
    tmp = tmp_path_factory.mktemp("tp")
    data = inputs()
    params_dir, grads_dir = tmp / "params", tmp / "jax" / "grads"
    try:
        # the reference imports while the params are drawn, once, for
        # every process to read
        ref = JaxReference(_JAX, tmp / "jax", deadline=WORLD_DEADLINE)
        for name in CONFIGS:
            save_params(np_params(tree_map(
                lambda t: tuple(t.shape),
                api.init_params(config(ARCHS, name, False))), 0),
                params_dir / name)
        ranks = spawn_world("test_torch_tp:tp_rank", DATA * MODEL,
                            tmp / "world", {"data": data,
                                            "grads_dir": str(grads_dir),
                                            "params_dir": str(params_dir)},
                            deadline=WORLD_DEADLINE)
        return ref.result(), ranks
    finally:
        shutil.rmtree(grads_dir, ignore_errors=True)
        shutil.rmtree(params_dir, ignore_errors=True)


def _rows(out) -> slice:
    d = out["coord"]["data"]
    return slice(d * B // DATA, (d + 1) * B // DATA)


@pytest.mark.parametrize("name,sp", RUNS)
def test_each_rank_holds_its_model_splits(runs, name, sp):
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import api
    from repro_torch.optim import optimizers as topt
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import AbstractMesh
    cfg = config(ARCHS, name, sp)
    mesh = AbstractMesh((DATA, MODEL), ("data", "model"))
    full = _flat(topt.tree_map(lambda t: tuple(t.shape),
                               api.init_params(cfg)))
    specs = _flat(rules.param_specs(api.init_params(cfg), cfg, mesh))
    split = 0
    for out in runs[1]:
        got = out[f"{name}_{int(sp)}/shapes"]
        assert set(got) == set(full)
        for k, shape in full.items():
            want = tuple(n // MODEL if e == "model" else n
                         for n, e in zip(shape, specs[k]))
            assert got[k] == want, k
            split += want != shape
    assert split > 0


@pytest.mark.parametrize("name,sp", RUNS)
def test_prefill_and_decode_logits_match(runs, name, sp):
    ref, ranks = runs
    tag = f"{name}_{int(sp)}/"
    for out in ranks:
        rows = _rows(out)
        for key in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
            np.testing.assert_allclose(out[tag + key].numpy(),
                                       ref[f"{ref_tag(name, sp)}/{key}"][rows],
                                       err_msg=key,
                                       **TOL)


def test_a_ring_cache_split_along_positions_matches_the_mesh_less_port(
        runs):
    """12 decode steps from an empty ring of 8 (window 8), each rank
    holding 2 of its slots: logits within the tolerance above of the
    mesh-less ring's."""
    for out in runs[1]:
        assert out["ring"] <= TOL["atol"]


@pytest.mark.parametrize("batch", [B, 1])
def test_a_quantized_cache_split_along_positions_matches_the_mesh_less_port(
        runs, batch):
    """kv_quant: the prefill cache padded, cut to each rank's positions
    and then quantized to int8 keeps its split (a rank other than the
    first does not read its chunk as positions [0, S_loc)); 4 decode
    steps' logits within the tolerance above of the mesh-less port's on
    the same cache."""
    for out in runs[1]:
        assert out[f"quant_b{batch}"] <= TOL["atol"]


def test_a_batch_the_data_axis_does_not_divide_steps_whole(runs):
    """Trainer(mesh=) on 3 rows over data 2: the batch is replicated over
    data (the step's mesh keeps only ``model``), and the gathered params
    after an SGD step equal the mesh-less trainer's."""
    for out in runs[1]:
        assert out["b3"] <= TOL["atol"]


@pytest.mark.parametrize("sp", [0, 1])
def test_vision_stub_prefill_matches_the_mesh_less_port(runs, sp):
    for out in runs[1]:
        got, want = out[f"vlm_{sp}"]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("name,sp", RUNS)
def test_train_step_loss_grads_and_sgd_params_match(runs, name, sp):
    ref, ranks = runs
    tag = f"{name}_{int(sp)}/"
    want_loss, want_aux = ref[ref_tag(name, sp) + "/loss"]
    for out in ranks:
        loss, aux = out[tag + "loss"]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        np.testing.assert_allclose(aux, want_aux, rtol=1e-5, atol=1e-7)
    for out in ranks:
        errors = out[tag + "errors"]
        assert len(errors) == len(out[tag + "shapes"])
        for k, (g_err, scale, p_err) in errors.items():
            assert g_err <= GRAD_TOL * scale, (k, g_err, scale)
            assert p_err <= TOL["atol"], (k, p_err)

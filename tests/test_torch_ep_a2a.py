"""Expert-parallel MoE (``moe_impl="ep_a2a"``) on an 8-rank gloo world
shaped (data 4, model 2), against the JAX package's ``ep_a2a`` on 8 host
devices (tests/test_ep_a2a.py's config: d 32, E 8, k 2, moe_d_ff 16,
cf 8.0, x [8, 4, 32]) and its dense oracle.

  * y within 1e-5 of the reference's ep_a2a y (the ff partials are
    summed by an ``all_reduce`` over ``model`` where the reference
    ``psum``s, ROADMAP Queue 3) and 1e-4 of the dense y; aux within 1e-6.
  * Gradients of the scalar sum(y * c) (c a fixed draw) with respect to
    x and to each rank's expert banks within 1e-4 of max|g| of the
    reference's ``jax.grad`` through ep_a2a.  Each rank's share of the
    scalar is its y shard's, divided by the model axis's size (y is
    replicated over ``model``); a replicated input's gradient is the sum
    of its replicas' (x over ``model``, the router over every rank).
  * At cf 0.25 tokens drop.  The capacity is a multiple of 128 a
    destination, so the drop needs more copies a shard than x [8, 4, 32]
    gives: there x is [8, 512, 32] (1024 tokens a shard, capacity 256 of
    512 copies a destination on average).  The keep mask equals the
    reference's (its routing re-run in the subprocess with the same
    formulas) and y is within 1e-5 of the reference's ep_a2a.
"""
import numpy as np
import pytest
import torch

from torch_dist_common import JaxReference, spawn_world

CFG = dict(name="t", arch_type="moe", num_layers=1, d_model=32, num_heads=2,
           num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=128,
           num_experts=8, top_k=2, moe_d_ff=16, dtype="float32",
           capacity_factor=8.0)
DATA, MODEL = 4, 2

_JAX = """
import os
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import ArchConfig
from repro.models.moe import moe_apply, router_topk
from repro.sharding.context import mesh_context
from repro.sharding.ep import _round_up

z = np.load(os.environ["INPUTS"])
cfg = ArchConfig(**{CFG!r})
mesh = jax.make_mesh((4, 2), ("data", "model"))
params = {{k: jnp.asarray(z[k]) for k in ("router", "wi_gate", "wi_up",
                                          "wo")}}
pspec = {{"router": P(), "wi_gate": P("data", None, "model"),
          "wi_up": P("data", None, "model"), "wo": P("data", "model", None)}}
shard = (jax.tree.map(lambda s: NamedSharding(mesh, s), pspec,
                      is_leaf=lambda s: isinstance(s, P)),
         NamedSharding(mesh, P("data", None, None)))
out = {{}}
for tag, c in (("", cfg), ("drop", cfg.with_overrides(capacity_factor=0.25))):
    x = jnp.asarray(z["x" + tag])
    with mesh, mesh_context(mesh):
        y, aux = jax.jit(lambda p, x: moe_apply(p, x, c, impl="ep_a2a"),
                         in_shardings=shard)(params, x)
        if not tag:
            gp, gx = jax.jit(jax.grad(
                lambda p, x: jnp.sum(moe_apply(p, x, c, impl="ep_a2a")[0]
                                     * jnp.asarray(z["c"])),
                argnums=(0, 1)), in_shardings=shard)(params, x)
    out["y" + tag], out["aux" + tag] = np.asarray(y), np.asarray(aux)
    # the routing of each data shard, with ep.py's formulas
    keeps = []
    for x_loc in jnp.split(x, 4):
        tl = x_loc.reshape(-1, c.d_model)
        _, idx, _ = router_topk(params, tl, c)
        dest = idx.reshape(-1) // 2
        order = jnp.argsort(dest)
        counts = jnp.bincount(dest, length=4)
        starts = jnp.cumsum(counts) - counts
        rank = jnp.arange(dest.shape[0]) - starts[dest[order]]
        cap = _round_up(int(tl.shape[0] * 2 / 4 * c.capacity_factor) + 1,
                        128)
        keeps.append(np.asarray(rank < cap))
    out["keep" + tag] = np.stack(keeps)
out["gx"] = np.asarray(gx)
for k in gp:
    out["g_" + k] = np.asarray(gp[k])
x = jnp.asarray(z["x"])
out["y_dense"] = np.asarray(moe_apply(params, x, cfg, impl="dense")[0])
np.savez(os.environ["OUT"], **out)
""".format(CFG=CFG)


def _inputs() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.configs.base import ArchConfig
    from repro.models.moe import moe_init
    key = jax.random.key(0)
    params = moe_init(key, ArchConfig(**CFG), jnp.float32)
    out = {k: np.asarray(v) for k, v in params.items()}
    out["x"] = np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                            (8, 4, CFG["d_model"])))
    out["c"] = np.asarray(jax.random.normal(jax.random.fold_in(key, 2),
                                            (8, 4, CFG["d_model"])))
    out["xdrop"] = np.asarray(jax.random.normal(jax.random.fold_in(key, 3),
                                                (8, 512, CFG["d_model"])))
    return out


def _specs():
    return {"router": (None, None), "wi_gate": ("data", None, "model"),
            "wi_up": ("data", None, "model"), "wo": ("data", "model", None)}


def ep_rank(rank, world, inputs):
    import torch.distributed as dist
    from repro_torch.configs.base import ArchConfig
    from repro_torch.convert import local_shards_from_numpy
    from repro_torch.sharding import ep
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.context import mesh_context
    mesh = make_test_mesh(device="cpu")       # (data 4, model 2) of 8
    assert mesh.shape == {"data": DATA, "model": MODEL}
    cfg = ArchConfig(**CFG)
    full = {k: inputs[k] for k in _specs()}
    params = local_shards_from_numpy(full, _specs(), mesh, device="cpu")
    d = mesh.coordinate("data")
    rows = slice(2 * d, 2 * d + 2)
    out = {"data": d, "model": mesh.coordinate("model")}
    for tag, c in (("", cfg), ("drop", cfg.with_overrides(
            capacity_factor=0.25))):
        x = torch.tensor(inputs["x" + tag][rows])
        with mesh_context(mesh), torch.no_grad():
            y, aux = moe.moe_apply(params, x, c, "ep_a2a")
        tl = x.reshape(-1, c.d_model)
        _, idx, _ = moe.router_topk(params, tl, c)
        _, keep, _ = ep.dispatch(idx.reshape(-1) // 2, DATA,
                                 ep.capacity(tl.shape[0], c, DATA))
        out["y" + tag], out["aux" + tag], out["keep" + tag] = y, aux, keep
    x = torch.tensor(inputs["x"][rows]).requires_grad_(True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with mesh_context(mesh):
        y, _ = moe.moe_apply(leaves, x, cfg, "ep_a2a")
    share = torch.sum(y * torch.tensor(inputs["c"][rows])) / MODEL
    share.backward()
    gx, grouter = x.grad.clone(), leaves["router"].grad.clone()
    dist.all_reduce(gx, group=mesh.group("model"))
    dist.all_reduce(grouter)
    out["gx"], out["g_router"] = gx, grouter
    for k in ("wi_gate", "wi_up", "wo"):
        out["g_" + k] = leaves[k].grad
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    inputs = _inputs()
    ref = JaxReference(_JAX, tmp / "jax", inputs)
    ranks = spawn_world("test_torch_ep_a2a:ep_rank", DATA * MODEL,
                        tmp / "world", {"inputs": inputs})
    return inputs, ref.result(), ranks


def _shard(full, spec, out):
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import AbstractMesh
    mesh = AbstractMesh((DATA, MODEL), ("data", "model"))
    coord = {"data": out["data"], "model": out["model"]}
    return full[rules.shard_index(mesh, spec, full.shape, coord)]


@pytest.mark.parametrize("tag", ["", "drop"], ids=["cf8", "cf0.25"])
def test_ep_matches_the_reference_ep(runs, tag):
    _, ref, ranks = runs
    for out in ranks:
        want = _shard(ref["y" + tag], ("data",), out)
        assert float(np.abs(out["y" + tag].numpy() - want).max()) < 1e-5
        assert abs(float(out["aux" + tag]) - float(ref["aux" + tag])) < 1e-6


def test_ep_matches_the_dense_oracle(runs):
    _, ref, ranks = runs
    for out in ranks:
        want = _shard(ref["y_dense"], ("data",), out)
        assert float(np.abs(out["y"].numpy() - want).max()) < 1e-4


@pytest.mark.parametrize("tag", ["", "drop"], ids=["cf8", "cf0.25"])
def test_ep_drops_what_the_reference_drops(runs, tag):
    _, ref, ranks = runs
    for out in ranks:
        keep = out["keep" + tag].numpy()
        np.testing.assert_array_equal(keep, ref["keep" + tag][out["data"]])
        assert keep.all() == (tag == "")      # cf 0.25 does drop


@pytest.mark.parametrize("leaf", ["x", "router", "wi_gate", "wi_up", "wo"])
def test_ep_gradients_match_the_reference(runs, leaf):
    _, ref, ranks = runs
    want_full = ref["gx" if leaf == "x" else "g_" + leaf]
    spec = ("data",) if leaf == "x" else _specs()[leaf]
    scale = float(np.abs(want_full).max())
    for out in ranks:
        got = out["gx" if leaf == "x" else "g_" + leaf].numpy()
        want = _shard(want_full, spec, out)
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-4 * scale

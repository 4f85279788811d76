"""The ring interchange over a mesh against the JAX package's, on an
8-rank gloo world shaped (agent 4, data 2).

The reference's 8-device subprocess (``tests/test_collectives.py``'s
draws and mesh) runs ``make_ring_interchange`` at n = 64 and 16384 and
``MeshRingTransport(mesh).ring_step`` at n = 64; the port's world runs the
same on the same arrays, and also at n = 15000 (a data shard of 7500: 8
tiles, the last ragged; the reference's kernel takes whole tiles only),
held against the reference's host formula per row, then rolled.

Tolerance 1e-6 absolute, as the reference's own test: the normalizer is
the data shards' totals summed by an ``all_reduce`` where the reference
sums with a ``psum`` and the one-device update sums one vector, three
orders of the same float32 additions (ROADMAP Queue 3).  A group of one
(each rank's own) gives the one-launch update's bits.
"""
import numpy as np
import pytest
import torch

from torch_dist_common import JaxReference, spawn_world

M = 4
N_MESH = (64, 16384)            # through the reference's mesh too
N_ALL = N_MESH + (15000,)
TOL = 1e-6

_JAX = """
import os
import jax, jax.numpy as jnp, numpy as np
from repro.core.collectives import make_ring_interchange
from repro.core.engine import MeshRingTransport

z = np.load(os.environ["INPUTS"])
mesh = jax.make_mesh((4, 2), ("agent", "data"))
step = make_ring_interchange(mesh)
out = {}
for n in (64, 16384):
    w, r, a = (jnp.asarray(z[f"{k}{n}"]) for k in ("w", "r", "alpha"))
    out[f"ring{n}"] = np.asarray(step(w, r, a))
w, r, a = (jnp.asarray(z[f"{k}64"]) for k in ("w", "r", "alpha"))
out["engine64"] = np.asarray(MeshRingTransport(mesh).ring_step(w, r, a))
np.savez(os.environ["OUT"], **out)
"""


def _draws() -> dict:
    """tests/test_collectives.py's draws at each n: one Dirichlet score
    tiled over the M agents, rewards uniform > 0.4, alphas 0.5 to 2."""
    import jax
    import jax.numpy as jnp
    out = {}
    for i, n in enumerate(N_ALL):
        key = jax.random.fold_in(jax.random.key(0), i) if i else \
            jax.random.key(0)
        w = jax.random.dirichlet(key, jnp.ones(n))
        out[f"w{n}"] = np.asarray(jnp.tile(w[None], (M, 1)), np.float32)
        out[f"r{n}"] = np.asarray(
            jax.random.uniform(jax.random.fold_in(key, 1), (M, n)) > 0.4,
            np.float32)
        out[f"alpha{n}"] = np.asarray([0.5, 1.0, 1.5, 2.0], np.float32)
    return out


def ring_rank(rank, world, inputs):
    import torch.distributed as dist
    from repro_torch.core.collectives import make_ring_interchange
    from repro_torch.core.engine import MeshRingTransport
    from repro_torch.kernels import ignorance as ig
    from repro_torch.kernels import ops
    from repro_torch.sharding.context import make_mesh
    mesh = make_mesh((4, 2), ("agent", "data"), "cpu")
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    step = make_ring_interchange(mesh)
    out = {"coord": (mesh.coordinate("agent"), mesh.coordinate("data"))}
    for n in N_ALL:
        ig.ignorance_update_unnormalized.launches = 0
        ig.ignorance_update_group.all_reduces = 0
        out[f"ring{n}"] = step(t[f"w{n}"], t[f"r{n}"], t[f"alpha{n}"])
        out[f"counts{n}"] = (ig.ignorance_update_unnormalized.launches,
                             ig.ignorance_update_group.all_reduces)
    out["engine64"] = MeshRingTransport(mesh).ring_step(
        t["w64"], t["r64"], t["alpha64"])
    solo = [dist.new_group([i]) for i in range(world)][rank]
    for n in N_ALL:
        w, r, a = t[f"w{n}"][1], t[f"r{n}"][1], t[f"alpha{n}"][1]
        out[f"solo{n}"] = (ops.ignorance_update(w, r, a, group=solo),
                           ops.ignorance_update(w, r, a))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    draws = _draws()
    ref = JaxReference(_JAX, tmp / "jax", draws)
    ranks = spawn_world("test_torch_collectives:ring_rank", 8, tmp / "world",
                        {"inputs": draws})
    return draws, ref.result(), ranks


def _host_rolled(draws, n):
    """The reference's host formula per agent row, then the ring shift."""
    import jax.numpy as jnp
    from repro.core import scores
    w, r, a = (jnp.asarray(draws[f"{k}{n}"]) for k in ("w", "r", "alpha"))
    ref = jnp.stack([scores.ignorance_update(w[m], r[m], a[m])
                     for m in range(M)])
    return np.asarray(jnp.roll(ref, 1, axis=0))


def _port_rolled(draws, n):
    """The port's one-device update per agent row, then the ring shift."""
    from repro_torch.kernels import ops
    t = {k: torch.tensor(draws[f"{k}{n}"]) for k in ("w", "r", "alpha")}
    return torch.roll(torch.stack([ops.ignorance_update(
        t["w"][m], t["r"][m], t["alpha"][m]) for m in range(M)]), 1, 0)


@pytest.mark.parametrize("n", N_MESH)
def test_ring_matches_the_reference_mesh(runs, n):
    _, ref, ranks = runs
    for out in ranks:                   # every rank holds the whole w'
        got = out[f"ring{n}"].numpy()
        assert got.shape == (M, n)
        assert float(np.abs(got - ref[f"ring{n}"]).max()) < TOL


@pytest.mark.parametrize("n", N_ALL)
def test_ring_is_the_rolled_one_device_update(runs, n):
    draws, _, ranks = runs
    got = ranks[0][f"ring{n}"]
    one = _port_rolled(draws, n)
    assert float((got - one).abs().max()) < TOL
    assert float(np.abs(got.numpy() - _host_rolled(draws, n)).max()) < TOL
    # agent m + 1 holds agent m's update: row 0 is agent M - 1's
    for m in range(M):
        mine = _port_rolled(draws, n)[(m + 1) % M]
        assert float((got[(m + 1) % M] - mine).abs().max()) < TOL
    for out in ranks[1:]:
        assert torch.equal(out[f"ring{n}"], got)


@pytest.mark.parametrize("n", N_ALL)
def test_one_all_reduce_a_hop(runs, n):
    """One all-reduce a hop on every rank; the CPU runs the kernel's plain
    version, so its launch counter stays 0 (phase 20 of chip_smoke.py
    counts one launch a hop on the card)."""
    _, _, ranks = runs
    assert sorted(out["coord"] for out in ranks) == [
        (a, d) for a in range(4) for d in range(2)]
    assert all(out[f"counts{n}"] == (0, 1) for out in ranks)


def test_engine_ring_step_matches_the_reference(runs):
    _, ref, ranks = runs
    for out in ranks:
        assert float(np.abs(out["engine64"].numpy()
                            - ref["engine64"]).max()) < TOL
        assert torch.equal(out["engine64"], ranks[0]["ring64"])


@pytest.mark.parametrize("n", N_ALL)
def test_a_group_of_one_is_the_one_launch_bits(runs, n):
    for out in runs[2]:
        grouped, alone = out[f"solo{n}"]
        assert torch.equal(grouped, alone)

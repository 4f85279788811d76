"""Sharded fleets (``fleet_run(shard_axis="data")``) on a 4-rank gloo
world, against the port's unsharded fleet and the JAX package's sharded
fleet on 8 host devices.

A blob-size fleet of 8 sessions (the reference's blob fixture of
tests/test_torch_compiled.py, logistic agents, 2 rounds), the cohort
shared and ``data_batched``, each rank running 2 sessions.  Against the
port's unsharded ``fleet_run`` every field of every session is equal bit
for bit: on the CPU the vmapped products give each session's bits at any
batch size (tests/test_torch_compiled.py holds a fleet's session to
``compiled_session`` the same way), so no parting needs Queue 3's fleet
rule here.  Against the reference's ``fleet_run(shard_axis=)``, with its
draws replayed (``ReplayDraws``), the tolerances of
tests/test_torch_compiled.py's fleet test: exact masks, rungs and sends,
alphas rtol 1e-5, w atol 1e-6.
"""
import numpy as np
import pytest
import torch

from torch_dist_common import JaxReference, spawn_world

F, WORLD, ROUNDS, STEPS = 8, 4, 2, 60
FIELDS = ("alphas", "accs", "executed", "valid", "w", "w_trace", "sent",
          "codec_idx", "exhausted", "order", "ctrl_ema")

_JAX = """
import os
import jax, jax.numpy as jnp, numpy as np
from repro.core import compiled as JC
from repro.learners.logistic import LogisticRegression

z = np.load(os.environ["INPUTS"])
Xtr = [z["x0"], z["x1"]]
k = int(z["k"])
plan = JC.plan_for([LogisticRegression(steps=60) for _ in Xtr], k,
                   max_rounds=2)
keys = jnp.stack([jax.random.key(s) for s in range(8)])
out = {}
for db in (0, 1):
    Xs = [z[f"batched{i}"] for i in range(2)] if db else Xtr
    cls = z["cls_batched"] if db else z["ctr"]
    res = JC.fleet_run(plan, keys, [jnp.asarray(x) for x in Xs],
                       jnp.asarray(cls), data_batched=bool(db),
                       shard_axis="data")
    for name in ("executed", "valid", "sent", "codec_idx", "alphas", "w"):
        out[f"{name}{db}"] = np.asarray(getattr(res, name))
np.savez(os.environ["OUT"], **out)
"""


def _blob() -> dict:
    import jax
    from repro.data.partition import train_test_split, vertical_split
    from repro.data.synthetic import blob_fig3
    ds = blob_fig3(jax.random.key(0), n=240)
    tr, _ = train_test_split(0, 240)
    Xs = [np.array(x[tr]) for x in vertical_split(ds.X, ds.splits)]
    ctr = np.array(ds.classes[tr])
    out = {"x0": Xs[0], "x1": Xs[1], "ctr": ctr,
           "k": np.asarray(ds.num_classes),
           "cls_batched": np.stack([ctr] * F)}
    for i, x in enumerate(Xs):
        out[f"batched{i}"] = np.stack([x + np.float32(0.01 * s)
                                       for s in range(F)])
    return out


def _cohort(blob, batched: bool):
    if batched:
        return ([torch.tensor(blob[f"batched{i}"]) for i in range(2)],
                torch.tensor(blob["cls_batched"]))
    return ([torch.tensor(blob["x0"]), torch.tensor(blob["x1"])],
            torch.tensor(blob["ctr"]))


def fleet_rank(rank, world, blob):
    import jax
    from repro_torch.core import compiled as TC
    from repro_torch.learners.logistic import LogisticRegression
    from test_torch_comm_session import ReplayDraws
    plan = TC.plan_for([LogisticRegression(steps=STEPS, device="cpu")
                        for _ in range(2)], int(blob["k"]),
                       max_rounds=ROUNDS)
    keys = list(range(F))
    out = {}
    for db in (False, True):
        Xs, cls = _cohort(blob, db)
        out[f"sharded{db}"] = TC.fleet_run(plan, keys, Xs, cls,
                                           data_batched=db,
                                           shard_axis="data")
        if rank == 0:
            out[f"whole{db}"] = TC.fleet_run(plan, keys, Xs, cls,
                                             data_batched=db)
        out[f"replay{db}"] = TC.fleet_run(
            plan, keys, Xs, cls, data_batched=db, shard_axis="data",
            source=[ReplayDraws(jax.random.key(s), 2) for s in keys])
    try:
        TC.fleet_run(plan, keys, *_cohort(blob, False), shard_axis="data",
                     live=True)
        out["live"] = "ran"
    except ValueError as e:
        out["live"] = str(e)
    try:
        TC.fleet_run(plan, keys[:6], *_cohort(blob, False),
                     shard_axis="data")
        out["uneven"] = "ran"
    except ValueError as e:
        out["uneven"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    blob = _blob()
    ref = JaxReference(_JAX, tmp / "jax", blob)
    ranks = spawn_world("test_torch_fleet_sharded:fleet_rank", WORLD,
                        tmp / "world", {"blob": blob})
    return ref.result(), ranks


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_sharded_fleet_equals_the_unsharded_one(runs, batched):
    _, ranks = runs
    whole = ranks[0][f"whole{batched}"]
    assert tuple(whole.alphas.shape) == (F, ROUNDS, 2)
    for out in ranks:                    # every rank holds all F sessions
        got = out[f"sharded{batched}"]
        for name in FIELDS:
            assert torch.equal(getattr(got, name), getattr(whole, name)), \
                name
        for a, b in zip(_leaves(got.params), _leaves(whole.params)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("batched", [False, True], ids=["shared", "batched"])
def test_sharded_fleet_matches_the_reference_sharded_fleet(runs, batched):
    ref, ranks = runs
    db = int(batched)
    for out in ranks:
        got = out[f"replay{batched}"]
        for name in ("executed", "valid", "sent", "codec_idx"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          ref[f"{name}{db}"], name)
        np.testing.assert_allclose(got.alphas.numpy(), ref[f"alphas{db}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got.w.numpy(), ref[f"w{db}"], rtol=0,
                                   atol=1e-6)


def test_sharded_fleet_refuses_live_taps_and_uneven_fleets(runs):
    for out in runs[1]:
        assert "live emission" in out["live"]
        assert "do not divide a fleet of 6" in out["uneven"]

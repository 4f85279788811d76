"""The port's fleets (``repro_torch.core.compiled.fleet_run``: F sessions
in one vmapped program) against the JAX package's ``fleet_run``, on the
reference's blob fixture of tests/test_torch_compiled.py (n = 240), with
the reference's draws replayed (``ReplayDraws``, tests/
test_torch_comm_session.py).

Exact: each session's executed, valid, sent and codec rungs.  Within
tests/test_torch_compiled.py's tolerances: the alphas (rtol 1e-5) and the
ignorance vector (atol 1e-6).  A fleet's session is held to
``compiled_session`` with the same key bit for bit: on the CPU the vmapped
matrix products give the single session's bits.  Each fleet hop is one
call of the batched ignorance update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as jcodecs
from repro.core import compiled as JC
from repro_torch.comm import codecs as tcodecs
from repro_torch.core import compiled as TC
from repro_torch.kernels import ignorance as tig
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from test_torch_comm_session import ReplayDraws
from test_torch_compiled import CPU, LEARNERS, _j, _t, blob  # noqa: F401


# ================================================================ the fleet
def _fleet_pair(blob, learners, keys, data_batched=False, rounds=2,
                channel=None):
    Xtr, ctr, _, _, k = blob
    codec = (None, None) if channel is None else channel
    jplan = JC.plan_for([learners[0]() for _ in Xtr], k, max_rounds=rounds,
                        codec=codec[0])
    tplan = TC.plan_for([learners[1]() for _ in Xtr], k, max_rounds=rounds,
                        codec=codec[1])
    S = len(keys)
    jkeys = jnp.stack([jax.random.key(s) for s in keys])
    if data_batched:
        Xs = [np.stack([x + np.float32(0.01 * s) for s in range(S)])
              for x in Xtr]
        cls = np.stack([ctr] * S)
    else:
        Xs, cls = Xtr, ctr
    jres = JC.fleet_run(jplan, jkeys, _j(Xs), jnp.asarray(cls),
                        data_batched=data_batched)
    sources = [ReplayDraws(jax.random.key(s), len(Xtr)) for s in keys]
    tres = TC.fleet_run(tplan, keys, _t(Xs), torch.from_numpy(cls),
                        data_batched=data_batched, source=sources)
    return jplan, tplan, jres, tres, Xs, cls


def _assert_fleet_matches(jres, tres):
    for name in ("executed", "valid", "sent", "codec_idx"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)), name)
    np.testing.assert_allclose(tres.alphas.numpy(), np.asarray(jres.alphas),
                               rtol=1e-5)
    np.testing.assert_allclose(tres.w.numpy(), np.asarray(jres.w), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_fleet_matches_reference_fleet(blob, name):
    keys = [0, 1, 2, 3]
    _, tplan, jres, tres, _, _ = _fleet_pair(blob, LEARNERS[name], keys)
    assert tuple(tres.alphas.shape) == (4, 2, len(blob[0]))
    _assert_fleet_matches(jres, tres)


def test_fleet_int8_matches_reference_fleet(blob):
    _, _, jres, tres, _, _ = _fleet_pair(
        blob, LEARNERS["logistic"], [5, 6, 7],
        channel=(jcodecs.QuantCodec(8), tcodecs.QuantCodec(8)))
    _assert_fleet_matches(jres, tres)


def test_fleet_data_batched_matches_reference_fleet(blob):
    _, _, jres, tres, _, _ = _fleet_pair(blob, LEARNERS["logistic"],
                                         [1, 2, 3], data_batched=True)
    assert tuple(tres.alphas.shape) == (3, 2, len(blob[0]))
    _assert_fleet_matches(jres, tres)


@pytest.mark.parametrize("name,data_batched,channel", [
    ("logistic", False, None), ("mlp", False, None),
    ("logistic", True, None), ("logistic", False, "int8"),
    ("logistic", False, "topk")])
def test_fleet_session_equals_compiled_session(blob, name, data_batched,
                                               channel):
    """Session f of a fleet against ``compiled_session`` with key f, bit
    for bit on the CPU; one batched ignorance launch a hop."""
    Xtr, ctr, _, _, k = blob
    codec = {None: None, "int8": tcodecs.QuantCodec(8),
             "topk": tcodecs.TopKCodec()}[channel]
    plan = TC.plan_for([LEARNERS[name][1]() for _ in Xtr], k, max_rounds=2,
                       codec=codec)
    keys = [3, 4, 5]
    if data_batched:
        Xs = [torch.from_numpy(np.stack([x * np.float32(1 + 0.1 * s)
                                         for s in range(3)])) for x in Xtr]
        cls = torch.from_numpy(np.stack([ctr] * 3))
    else:
        Xs, cls = _t(Xtr), torch.from_numpy(ctr)
    fleet = TC.fleet_run(plan, keys, Xs, cls, data_batched=data_batched)
    for f in (0, 2):
        single = TC.compiled_session(
            plan, keys[f], [x[f] for x in Xs] if data_batched else Xs,
            cls[f] if data_batched else cls)
        for field in ("alphas", "accs", "executed", "valid", "w", "w_trace",
                      "sent", "codec_idx", "order"):
            assert torch.equal(getattr(fleet, field)[f],
                               getattr(single, field)), (field, f)
        for a, b in zip(jax.tree.leaves(single.params),
                        jax.tree.leaves(tuple(
                            TC.tree_map(lambda x, _f=f: x[_f], p)
                            for p in fleet.params))):
            assert torch.equal(a, b)


def test_fleet_books_one_batched_ignorance_launch_a_hop(blob, monkeypatch):
    """Under vmap each hop is one call of the batched update (its plain
    version on the CPU), whatever the fleet's size."""
    Xtr, ctr, _, _, k = blob
    calls = []
    inner = tig.ignorance_update_batched

    def counted(w, r, a):
        calls.append(tuple(w.shape))
        return inner(w, r, a)
    monkeypatch.setattr(tig, "ignorance_update_batched", counted)
    plan = TC.plan_for([TLogistic(steps=5, device=CPU) for _ in Xtr], k,
                       max_rounds=2)
    TC.fleet_run(plan, list(range(6)), _t(Xtr), torch.from_numpy(ctr))
    assert calls == [(6, len(ctr))] * (2 * len(Xtr))

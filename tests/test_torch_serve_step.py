"""The port's compiled serve step (``repro_torch.core.compiled``:
``serve_session``, ``serve_batch``, and ``Protocol(backend="compiled").
predict_distributed``, which runs it and replays the serve ledger)
against the JAX package's, on the reference's blob fixture (n = 240).

The serve step is held to the reference's on the same parameters (the
reference's fitted session, converted from numpy) and the same draws
(replayed from the reference's serve keys by ``ReplayDraws``,
tests/test_torch_comm_session.py).  Exact: the predictions, ``sent``, the
rungs (``codec_idx``) and ``exhausted``.  The blocks agree within 1e-6 of
their largest magnitude (one float32 ulp at the blob's block values of
~10-20): the reference's scan contracts ``acc + alpha * code`` into one
fused multiply-add where the port, as the eager reference, rounds the
product first, and the mechanism's norm is a float64 sum in the port.  Each
``Protocol`` is held to the reference's: predictions, the ledger (every
entry), skips, exhaustion and DP releases exact, with its own fit (the
fits agree within float32 rounding, tests/test_torch_compiled.py).

The port's compiled serve is also held to the port's eager serve, bit
for bit: predictions, ledger, skips, exhaustion, DP releases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetedTransport as JBudgeted
from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm import codecs as jcodecs
from repro.comm.privacy import GaussianMechanism as JMech
from repro.control.adaptive import ServeController as JServeController
from repro.core import compiled as JC
from repro.core import engine as J
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.logistic import LogisticRegression as JLogistic
from repro_torch.comm import BudgetedTransport as TBudgeted
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.privacy import GaussianMechanism as TMech
from repro_torch.control.adaptive import ServeController as TServeController
from repro_torch.core import compiled as TC
from repro_torch.core import engine as T
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from test_torch_comm_session import ReplayDraws

CPU = "cpu"
ROUNDS = 3
STEPS = 40
KEY = 11
SERVE_KEY = 5


@pytest.fixture(scope="module")
def blob():
    ds = blob_fig3(jax.random.key(0), n=240)
    tr, te = train_test_split(0, 240)
    Xs = vertical_split(ds.X, ds.splits)
    return ([np.array(x[tr]) for x in Xs], np.array(ds.classes[tr]),
            [np.array(x[te]) for x in Xs], np.array(ds.classes[te]),
            ds.num_classes)


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


@pytest.fixture(scope="module")
def fitted(blob):
    """The reference's compiled session, and its params, alphas and valid
    as the port's tensors."""
    Xtr, ctr, _, _, k = blob
    jplan = JC.plan_for([JLogistic(steps=STEPS)] * len(Xtr), k,
                        max_rounds=ROUNDS)
    jres = JC.compiled_session(jplan, jax.random.key(KEY), _j(Xtr),
                               jnp.asarray(ctr))
    as_t = lambda a: torch.from_numpy(np.array(a))     # noqa: E731
    tres = TC.SessionResult(
        alphas=as_t(jres.alphas), accs=None, executed=None,
        valid=as_t(jres.valid), params=jax.tree.map(as_t, jres.params),
        w_trace=None, w=None, sent=None, codec_idx=None, exhausted=None,
        order=None, ctrl_ema=None)
    return jres, tres


def _serve_costs(blob):
    _, _, Xte, _, k = blob
    return JBudgetSpec().serve_costs((Xte[0].shape[0], k))


# name -> plan_for keywords (reference, port) and the budget counters
SERVE = {
    "fp32": ({"serve_codec": jcodecs.Fp32Codec()},
             {"serve_codec": tcodecs.Fp32Codec()}),
    "fp16": ({"serve_codec": jcodecs.Fp16Codec()},
             {"serve_codec": tcodecs.Fp16Codec()}),
    "int8": ({"serve_codec": jcodecs.QuantCodec(8)},
             {"serve_codec": tcodecs.QuantCodec(8)}),
    "int4": ({"serve_codec": jcodecs.QuantCodec(4)},
             {"serve_codec": tcodecs.QuantCodec(4)}),
    "int8-deterministic": (
        {"serve_codec": jcodecs.QuantCodec(8, stochastic=False)},
        {"serve_codec": tcodecs.QuantCodec(8, stochastic=False)}),
    "topk": ({"serve_codec": jcodecs.TopKCodec()},
             {"serve_codec": tcodecs.TopKCodec()}),
    "dp": ({"privacy": JMech(epsilon=1.0)}, {"privacy": TMech(epsilon=1.0)}),
    "margin": ({"serve_controller": JServeController(stat="margin")},
               {"serve_controller": TServeController(stat="margin")}),
    "entropy": ({"serve_controller": JServeController(stat="entropy")},
                {"serve_controller": TServeController(stat="entropy")}),
    "budget": ({"budget": JBudgetSpec(session_bits=10 ** 6)},
               {"budget": TBudgetSpec(session_bits=10 ** 6)}),
    "budget-margin": (
        {"budget": JBudgetSpec(session_bits=10 ** 6),
         "serve_controller": JServeController(stat="margin")},
        {"budget": TBudgetSpec(session_bits=10 ** 6),
         "serve_controller": TServeController(stat="margin")}),
}


def _plans(blob, name):
    Xtr, _, _, _, k = blob
    jkw, tkw = SERVE[name]
    m = len(Xtr)
    return (JC.plan_for([JLogistic(steps=STEPS)] * m, k, max_rounds=ROUNDS,
                        **jkw),
            TC.plan_for([TLogistic(steps=STEPS, device=CPU)] * m, k,
                        max_rounds=ROUNDS, **tkw))


def _replay(blob):
    source = ReplayDraws(jax.random.key(0), len(blob[0]))
    source.final_key = jax.random.key(SERVE_KEY)
    return source


def _assert_serve_equal(jout, tout):
    for field in ("preds", "sent", "codec_idx", "exhausted"):
        np.testing.assert_array_equal(getattr(tout, field).numpy(),
                                      np.asarray(getattr(jout, field)),
                                      field)
    want = np.asarray(jout.blocks)
    np.testing.assert_allclose(tout.blocks.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


def _budget_counters(blob, case):
    """(rem_session, rem_link) for a budget case: ``walk`` ships the first
    block at fp32, degrades the second to int8 and skips the third (the
    session runs dry); ``skip`` ships nothing (head-only); ``link`` caps
    one link below every rung."""
    costs = _serve_costs(blob)
    m = len(blob[0])
    if case == "walk":
        return costs[0] + costs[2] + 10, None
    if case == "skip":
        return 0, None
    return None, [2 ** 31 - 1] * (m - 1) + [min(costs) - 1]


# ====================================================== the serve step itself
@pytest.mark.parametrize("name", [n for n in SERVE if "budget" not in n])
def test_serve_session_matches_reference(blob, fitted, name):
    """Every serve channel without a budget, two request tags and the
    untagged call, on the reference's params and draws."""
    jres, tres = fitted
    Xte = blob[2]
    jplan, tplan = _plans(blob, name)
    source = _replay(blob)
    for request in (None, 0, 7):
        jout = JC.serve_session(
            jplan, jres, jcodecs.serve_key(jax.random.key(SERVE_KEY),
                                           request), _j(Xte))
        tout = TC.serve_session(tplan, tres, 0, _t(Xte), request=request,
                                source=source)
        _assert_serve_equal(jout, tout)
        if name in ("margin", "entropy"):
            # the controller picked real rungs (an encoded block)
            assert (tout.codec_idx[1:] >= 0).all()


@pytest.mark.parametrize("name", ["budget", "budget-margin"])
@pytest.mark.parametrize("case", ["walk", "skip", "link"])
def test_budgeted_serve_matches_reference(blob, fitted, name, case):
    """The ladder walk under the budget counters: degrade, then skip and
    exhaust; a full skip serves head-only; a link cap skips one block."""
    jres, tres = fitted
    Xte = blob[2]
    jplan, tplan = _plans(blob, name)
    rem_s, rem_l = _budget_counters(blob, case)
    jout = JC.serve_session(
        jplan, jres, jcodecs.serve_key(jax.random.key(SERVE_KEY), 3),
        _j(Xte), rem_session=rem_s, rem_link=rem_l)
    tout = TC.serve_session(tplan, tres, 0, _t(Xte), request=3,
                            rem_session=rem_s, rem_link=rem_l,
                            source=_replay(blob))
    _assert_serve_equal(jout, tout)
    sent = tout.sent.numpy()
    if case == "walk" and name == "budget":
        assert list(tout.codec_idx.numpy()) == [-1, 0, 2, -1]
        assert bool(tout.exhausted)
    if case == "skip":
        assert not sent.any() and bool(tout.exhausted)
        head = tout.blocks[0].argmax(dim=-1)
        assert torch.equal(tout.preds, head)      # head-only
    if case == "link":
        assert not sent[-1] and sent[1:-1].all()
        assert not bool(tout.exhausted)


def test_max_round_matches_reference(blob, fitted):
    jres, tres = fitted
    Xte = blob[2]
    jplan, tplan = _plans(blob, "int8")
    rounds = jnp.arange(ROUNDS)[:, None] <= 0
    jout = JC.serve_session(jplan, jres, jcodecs.serve_key(
        jax.random.key(SERVE_KEY), 1), _j(Xte), valid=jres.valid & rounds)
    tvalid = tres.valid & (torch.arange(ROUNDS) <= 0)[:, None]
    tout = TC.serve_session(tplan, tres, 0, _t(Xte), request=1,
                            valid=tvalid, source=_replay(blob))
    _assert_serve_equal(jout, tout)


def test_serve_batch_matches_reference(blob, fitted):
    """The batched step over three requests and a pad slot (deliver all
    False), against the reference's ``serve_batch``; each slot also
    equals the port's ``serve_session`` for it alone, bit for bit."""
    jres, tres = fitted
    Xte = blob[2]
    m = len(Xte)
    jplan, tplan = _plans(blob, "int8")
    source = _replay(blob)
    big = 2 ** 31 - 1
    rows = [np.arange(r * 16, r * 16 + 24) for r in range(3)]
    jslots, tslots = [], []
    for r, idx in enumerate(rows + [rows[0]]):
        deliver = np.full(m, r < 3)
        Xb = [x[idx] for x in Xte]
        jslots.append({"key": jcodecs.serve_key(jax.random.key(SERVE_KEY),
                                                r % 3),
                       "Xs": tuple(_j(Xb)), "params": jres.params,
                       "alphas": jres.alphas, "valid": jres.valid,
                       "rem_session": jnp.asarray(big, jnp.int32),
                       "rem_link": jnp.asarray([big] * m, jnp.int32),
                       "deliver": deliver})
        tslots.append({"key": np.zeros(2, np.uint32), "request": r % 3,
                       "source": source, "Xs": _t(Xb),
                       "params": tres.params, "alphas": tres.alphas,
                       "valid": tres.valid, "rem_session": None,
                       "rem_link": None, "deliver": deliver})
    jout = JC.serve_batch(jplan, jslots)
    tout = TC.serve_batch(tplan, tslots)
    for r in range(4):
        _assert_serve_equal(jax.tree.map(lambda a, _r=r: a[_r], jout),
                            TC.ServeResult(*[f[r] for f in tout]))
    assert not tout.sent[3].any()                 # the pad ships nothing
    for r in range(3):
        alone = TC.serve_session(tplan, tres, 0, _t([x[rows[r]]
                                                     for x in Xte]),
                                 request=r, source=source)
        for got, want in zip(tout, alone):
            assert torch.equal(got[r], want), r


# ===================================================== Protocol on both sides
def _budget_bits(blob):
    """A session cap that the fit (every hop at fp32) leaves one and a
    half fp32 score blocks of: the first serve degrades, then runs dry."""
    Xtr, ctr, _, _, _ = blob
    n, m = len(ctr), len(Xtr)
    spec = JBudgetSpec()
    return ((m - 1) * 2 * n * 32 + ROUNDS * m * spec.hop_costs(n)[0]
            + 3 * _serve_costs(blob)[0] // 2)


PROTOCOLS = {
    "int8-dp": lambda b: (
        J.MeteredTransport(serve_codec=jcodecs.QuantCodec(8),
                           privacy=JMech(epsilon=4.0, clip=0.1)),
        T.MeteredTransport(serve_codec=tcodecs.QuantCodec(8),
                           privacy=TMech(epsilon=4.0, clip=0.1))),
    "budget": lambda b: (JBudgeted(JBudgetSpec(session_bits=_budget_bits(b))),
                         TBudgeted(TBudgetSpec(session_bits=_budget_bits(b)))),
    "margin": lambda b: (
        J.MeteredTransport(serve_controller=JServeController()),
        T.MeteredTransport(serve_controller=TServeController())),
}


def _protocol_pair(blob, name):
    Xtr, ctr, _, _, k = blob
    jt, tt = PROTOCOLS[name](blob)
    m = len(Xtr)
    jproto = J.Protocol(J.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                        transport=jt, backend="compiled")
    jproto.fit(jax.random.key(KEY),
               J.endpoints_for([JLogistic(steps=STEPS)] * m, _j(Xtr)),
               jnp.asarray(ctr))
    source = ReplayDraws(jax.random.key(KEY), m)
    tproto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                        transport=tt, backend="compiled", device=CPU,
                        draws=source)
    tproto.fit(KEY, T.endpoints_for([TLogistic(steps=STEPS, device=CPU)] * m,
                                    _t(Xtr)), torch.from_numpy(ctr))
    # the reference serves from its key after the run (its _evolved_key)
    source.final_key = jproto._evolved_key(jproto._compiled_ctx[2])
    return jproto, tproto


@pytest.mark.parametrize("name", sorted(PROTOCOLS))
def test_protocol_compiled_serve_matches_reference(blob, name):
    """Three predict calls (untagged, then requests 0 and 4): the default
    serve key, the ledger, skips, exhaustion and releases."""
    Xte = blob[2]
    jproto, tproto = _protocol_pair(blob, name)
    for request in (None, 0, 4):
        jp = jproto.predict_distributed(_j(Xte), request=request)
        tp = tproto.predict_distributed(_t(Xte), request=request)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jt, tt = jproto.transport, tproto.transport
    assert tt.log.entries == jt.log.entries
    assert any(e["kind"] == "score_block" for e in tt.log.entries)
    if name == "budget":
        assert (tt.skipped, tt.exhausted) == (jt.skipped, jt.exhausted)
        assert tt.exhausted and tt.skipped
    if jt.accountant is not None:
        assert tt.accountant.releases == jt.accountant.releases


# ================================================ the port's two backends
def _port_transport(name):
    return {
        "fp32": lambda: T.MeteredTransport(),
        "int8": lambda: T.MeteredTransport(serve_codec=tcodecs.QuantCodec(8)),
        "int4-dp-rdp": lambda: T.MeteredTransport(
            serve_codec=tcodecs.QuantCodec(4),
            privacy=TMech(epsilon=1.0), accountant=_rdp()),
        "topk": lambda: T.MeteredTransport(serve_codec=tcodecs.TopKCodec()),
        "budget": lambda: TBudgeted(TBudgetSpec(session_bits=60000)),
        "margin": lambda: T.MeteredTransport(
            serve_controller=TServeController(stat="margin")),
        "entropy-dp": lambda: T.MeteredTransport(
            serve_controller=TServeController(stat="entropy"),
            privacy=TMech(epsilon=2.0, clip=0.1)),
    }[name]()


def _rdp():
    from repro_torch.control.accounting import RDPAccountant
    return RDPAccountant()


@pytest.mark.parametrize("name", ["fp32", "int8", "int4-dp-rdp", "topk",
                                  "budget", "margin", "entropy-dp"])
def test_compiled_serve_equals_eager_serve(blob, name):
    """The port's compiled serve against its eager serve, bit for bit:
    predictions (three requests and a max_round call), the ledger, skips,
    exhaustion, DP releases."""
    Xtr, ctr, Xte, _, k = blob
    runs = {}
    for backend in ("eager", "compiled"):
        t = _port_transport(name)
        proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=ROUNDS),
                           transport=t, backend=backend, device=CPU)
        proto.fit(KEY, T.endpoints_for([TLogistic(steps=STEPS, device=CPU)]
                                       * len(Xtr), _t(Xtr)),
                  torch.from_numpy(ctr))
        preds = [proto.predict_distributed(_t(Xte), request=r)
                 for r in (None, 0, 2)]
        preds.append(proto.predict_distributed(_t(Xte), max_round=0))
        runs[backend] = (preds, t)
    (ep, et), (cp, ct) = runs["eager"], runs["compiled"]
    for a, b in zip(ep, cp):
        assert torch.equal(a, b)
    assert ct.log.entries == et.log.entries
    if hasattr(et, "budget"):
        assert (ct.skipped, ct.exhausted) == (et.skipped, et.exhausted)
    if et.accountant is not None:
        assert ct.accountant.releases == et.accountant.releases

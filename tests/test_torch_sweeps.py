"""The port's compiled sweeps (``repro_torch.core.compiled``:
``quant_sweep_run`` with and without its serve axis, ``control_sweep_run``
with ``live=``) and the quantize kernels' device-qmax route
(``kernels/quantize.py::quantize_dequant_rows`` /
``quantize_dequant_block_rows`` with a tensor ``qmax``, and their custom
ops in ``kernels/ops.py``), on the reference's blob fixture (n = 240).

Each sweep row is held to the per-config runs of the port bit for bit
(``compiled_session`` and ``serve_session`` of the static plan, and the
eager ``Protocol``), not to the reference's sweep, which misses its own
static runs by an ulp of the scale (ROADMAP Queue 3): the kernel forms
``1.0f / qmax``, the reciprocal the static path passes.  Against the
reference's per-config ``compiled_session`` / ``serve_session`` on the
same arrays and its draws replayed: integers exact, alphas within rtol
1e-5 and w within atol 1e-6 (Queue 3).

Ports of the reference's control-sweep pins (tests/test_compiled.py:
the controller's (cut, beta) configs, the budget caps with an uncapped
row, the "neither" rule; tests/test_telemetry_live.py: the live control
sweep), then the device-qmax op: its plain version, fake implementation,
vmap rule (a batched and an unbatched range) and its C call on a
stand-in library, and the host range check.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm import codecs as jcodecs
from repro.core import compiled as JC
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.logistic import LogisticRegression as JLogistic
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm import codecs as tcodecs
from repro_torch.control.adaptive import AdaptiveController
from repro_torch.core import compiled as TC
from repro_torch.core import engine as T
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as tq
from repro_torch.learners.logistic import LogisticRegression as TLogistic
from repro_torch.telemetry import MetricsRegistry
from repro_torch.telemetry.live import LiveSink, installed
from test_torch_comm_session import ReplayDraws

CPU = "cpu"
KEY = 0
QMAXES = [127.0, 31.0, 7.0]
# the static codec at each swept range: int8, a 6-bit codec built for the
# test (QuantCodec(bits=6).qmax == 31) and int4
BITS = {127.0: 8, 31.0: 6, 7.0: 4}
RESULT_FIELDS = ("alphas", "accs", "executed", "valid", "w", "w_trace",
                 "sent", "codec_idx", "exhausted", "order")


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


def _plan(blob, bits=8, rounds=2, **kw):
    Xtr, _, _, _, k = blob
    return TC.plan_for([TLogistic(steps=30, device=CPU) for _ in Xtr], k,
                       max_rounds=rounds,
                       codec=tcodecs.QuantCodec(bits=bits), **kw)


def _row(result, s):
    return result._replace(**{f: getattr(result, f)[s]
                              for f in result._fields if f != "params"},
                           params=tuple(TC.tree_map(lambda x: x[s], p)
                                        for p in result.params))


def _assert_equal_results(got, want):
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if field == "params":
            for pa, pb in zip(a, b):
                for la, lb in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
                    assert torch.equal(la, lb), field
        else:
            assert torch.equal(a, b), field


# ============================================================ codec sweep
def test_quant_sweep_rows_equal_per_config_runs(blob):
    """Each row = ``compiled_session`` of the static plan at its range,
    every field bit for bit, and = the eager Protocol's w and alphas."""
    Xtr, ctr, _, _, k = blob
    Xs, c = _t(Xtr), torch.from_numpy(ctr)
    sweep = TC.quant_sweep_run(_plan(blob), [KEY] * 3, Xs, c, QMAXES)
    assert tuple(sweep.alphas.shape) == (3, 2, len(Xtr))
    for s, qm in enumerate(QMAXES):
        plan = _plan(blob, bits=BITS[qm])
        assert plan.codec.qmax == qm
        _assert_equal_results(_row(sweep, s),
                              TC.compiled_session(plan, KEY, Xs, c))
        proto = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=2),
                           transport=T.MeteredTransport(codec=plan.codec),
                           device=CPU)
        fit = proto.fit(KEY, T.endpoints_for(
            [TLogistic(steps=30, device=CPU) for _ in Xtr], Xs), c)
        assert torch.equal(sweep.w[s], proto._session.state.w)
        assert [comp.alpha for comp in fit.components] == [
            float(a) for a, v in zip(sweep.alphas[s].reshape(-1),
                                     sweep.valid[s].reshape(-1)) if v]
    # the wire bits a session, from the range
    assert [tcodecs.quant_bits_per_element(q) for q in QMAXES] == [8, 6, 4]


def test_quant_sweep_serve_axis_equals_per_config_serve(blob):
    Xtr, ctr, Xte, _, k = blob
    Xs, c = _t(Xtr), torch.from_numpy(ctr)
    res, serve = TC.quant_sweep_run(_plan(blob), [KEY, 1, KEY], Xs, c,
                                    QMAXES, serve_Xs=_t(Xte))
    keys = [KEY, 1, KEY]
    for s, qm in enumerate(QMAXES):
        plan = _plan(blob, bits=BITS[qm])
        single = TC.compiled_session(plan, keys[s], Xs, c)
        _assert_equal_results(_row(res, s), single)
        want = TC.serve_session(plan, single, keys[s], _t(Xte))
        for field in want._fields:
            assert torch.equal(getattr(serve, field)[s],
                               getattr(want, field)), (s, field)
        # the serve step's sent blocks are every non-head agent's
        assert serve.sent[s].tolist() == [False] + [True] * (len(Xtr) - 1)


def test_quant_sweep_matches_reference_per_config_runs(blob):
    """The sweep's rows against the reference's per-config compiled
    sessions and serve steps (the reference's draws replayed)."""
    Xtr, ctr, Xte, _, k = blob
    m = len(Xtr)
    sources = [ReplayDraws(jax.random.key(KEY), m) for _ in QMAXES]
    for src in sources:
        src.final_key = jax.random.key(KEY)    # the untagged serve key's
    res, serve = TC.quant_sweep_run(_plan(blob), [KEY] * 3, _t(Xtr),
                                    torch.from_numpy(ctr), QMAXES,
                                    serve_Xs=_t(Xte), source=sources)
    for s, qm in enumerate(QMAXES):
        jplan = JC.plan_for([JLogistic(steps=30) for _ in Xtr], k,
                            max_rounds=2,
                            codec=jcodecs.QuantCodec(bits=BITS[qm]))
        key = jax.random.key(KEY)
        single = JC.compiled_session(jplan, key, _j(Xtr), jnp.asarray(ctr))
        for field in ("executed", "valid", "sent", "codec_idx"):
            np.testing.assert_array_equal(getattr(res, field)[s].numpy(),
                                          np.asarray(getattr(single, field)))
        np.testing.assert_allclose(res.alphas[s].numpy(),
                                   np.asarray(single.alphas), rtol=1e-5)
        np.testing.assert_allclose(res.w[s].numpy(), np.asarray(single.w),
                                   rtol=0, atol=1e-6)
        want = JC.serve_session(jplan, single, jax.random.fold_in(
            key, jcodecs.SERVE_FOLD), _j(Xte))
        np.testing.assert_array_equal(serve.preds[s].numpy(),
                                      np.asarray(want.preds))
        np.testing.assert_array_equal(serve.codec_idx[s].numpy(),
                                      np.asarray(want.codec_idx))


def test_quant_sweep_is_one_quantize_launch_a_hop(blob, monkeypatch):
    """Under vmap each hop's quantize is one call of the rows route with
    the ranges as a tensor, and each served block's one of the block
    route, whatever the number of ranges: S = 1 and S = 3 make the same
    calls."""
    Xtr, ctr, Xte, _, k = blob
    calls = []
    for name in ("quantize_dequant_rows", "quantize_dequant_block_rows"):
        inner = getattr(tq, name)

        def counted(x, u, qmax, *, bn=tq.DEFAULT_BN, _inner=inner,
                    _name=name):
            calls.append((_name, tuple(x.shape[1:]), tuple(qmax.shape)))
            return _inner(x, u, qmax, bn=bn)
        monkeypatch.setattr(tq, name, counted)
    per_s = {}
    for qmaxes in ([31.0], QMAXES):
        calls.clear()
        TC.quant_sweep_run(_plan(blob), [KEY] * len(qmaxes), _t(Xtr),
                           torch.from_numpy(ctr), qmaxes,
                           serve_Xs=_t(Xte))
        assert all(q == (len(qmaxes),) for _, _, q in calls)
        per_s[len(qmaxes)] = [(nm, sh) for nm, sh, _ in calls]
    m, n = len(Xtr), len(ctr)
    assert per_s[1] == per_s[3]
    assert per_s[3] == ([("quantize_dequant_rows", (n,))] * (2 * m)
                        + [("quantize_dequant_block_rows",
                            (len(blob[3]), k))] * (m - 1))


@pytest.mark.parametrize("bad", [[0.5], [128.0], [127.0, float("nan")]])
def test_quant_sweep_checks_ranges_on_the_host(blob, bad):
    Xtr, ctr, _, _, _ = blob
    with pytest.raises(ValueError, match=r"\[1, 127\]"):
        TC.quant_sweep_run(_plan(blob), [KEY] * len(bad), _t(Xtr),
                           torch.from_numpy(ctr), bad)


def test_sweep_argument_rules(blob):
    Xtr, ctr, _, _, k = blob
    shapes = tuple(tuple(x.shape[1:]) for x in Xtr)
    budgeted = _plan(blob, budget=TBudgetSpec(session_bits=40_000))
    plain = TC.plan_for([TLogistic(steps=5, device=CPU) for _ in Xtr], k)
    for plan in (budgeted, plain):
        with pytest.raises(ValueError, match="plain QuantCodec"):
            TC.make_session_fn(plan, shapes, qmax_arg=True)
    with pytest.raises(ValueError, match="plain QuantCodec"):
        TC.make_serve_fn(budgeted, shapes, qmax_arg=True)
    with pytest.raises(ValueError, match="pick one"):
        TC.make_session_fn(_plan(blob), shapes, qmax_arg=True,
                           control_arg=True)
    with pytest.raises(ValueError, match="neither"):
        TC.make_session_fn(plain, shapes, control_arg=True)
    with pytest.raises(ValueError, match="ranges"):
        TC.quant_sweep_run(_plan(blob), [0, 1], _t(Xtr),
                           torch.from_numpy(ctr), [127.0])


# ========================================================== control sweep
def test_control_sweep_controller_matches_static(blob):
    """tests/test_compiled.py's pin: four (cuts, beta) configs in one
    program, each row = the static plan's compile bit for bit, one build
    for the sweep."""
    Xtr, ctr, _, _, k = blob
    ladder = (tcodecs.Fp16Codec(), tcodecs.QuantCodec(bits=4))
    configs = [((0.5,), 0.0), ((0.1,), 0.0), ((0.9,), 0.5), ((0.3,), 0.9)]

    def mk(cut, beta):
        return TC.plan_for(
            [TLogistic(steps=30, device=CPU) for _ in Xtr], k, max_rounds=2,
            controller=AdaptiveController(ladder=ladder, thresholds=cut,
                                          beta=beta))
    Xs, c = _t(Xtr), torch.from_numpy(ctr)
    TC.TRACE_COUNTS.clear()
    sweep = TC.control_sweep_run(mk(*configs[0]), [KEY] * 4, Xs, c,
                                 cuts=[cut for cut, _ in configs],
                                 betas=[b for _, b in configs])
    assert TC.TRACE_COUNTS == {"control_sweep": 1}
    rungs = set()
    for s, (cut, beta) in enumerate(configs):
        single = TC.compiled_session(mk(cut, beta), KEY, Xs, c)
        _assert_equal_results(_row(sweep, s), single)
        rungs |= set(single.codec_idx.reshape(-1).tolist())
    assert {0, 1} <= rungs                     # the configs pick both rungs


def test_control_sweep_budget_caps_match_static(blob):
    """Caps as operands, an uncapped (None) row as the int32 sentinel: each
    row = the static compile, the uncapped one = the uncapped plan's."""
    Xtr, ctr, _, _, k = blob
    ladder = (tcodecs.QuantCodec(bits=8), tcodecs.QuantCodec(bits=4))
    caps = [40_000, 20_000, 12_000, None]

    def mk(cap):
        return TC.plan_for([TLogistic(steps=30, device=CPU) for _ in Xtr], k,
                           max_rounds=3,
                           budget=TBudgetSpec(session_bits=cap,
                                              ladder=ladder))
    Xs, c = _t(Xtr), torch.from_numpy(ctr)
    TC.TRACE_COUNTS.clear()
    sweep = TC.control_sweep_run(mk(caps[0]), [KEY] * 4, Xs, c,
                                 session_bits=caps)
    assert TC.TRACE_COUNTS == {"control_sweep": 1}
    for s, cap in enumerate(caps):
        _assert_equal_results(_row(sweep, s),
                              TC.compiled_session(mk(cap), KEY, Xs, c))
    assert bool(sweep.exhausted[2]) and not bool(sweep.exhausted[3])


def test_control_sweep_matches_reference_static(blob):
    """The budget sweep's rows against the reference's static compiles
    (its draws replayed): sent, rungs, exhaustion exact."""
    Xtr, ctr, _, _, k = blob
    caps = [40_000, 12_000, None]
    jladder = (jcodecs.QuantCodec(bits=8), jcodecs.QuantCodec(bits=4))
    plan = TC.plan_for([TLogistic(steps=30, device=CPU) for _ in Xtr], k,
                       max_rounds=3, budget=TBudgetSpec(
                           session_bits=caps[0],
                           ladder=(tcodecs.QuantCodec(bits=8),
                                   tcodecs.QuantCodec(bits=4))))
    sources = [ReplayDraws(jax.random.key(KEY), len(Xtr)) for _ in caps]
    sweep = TC.control_sweep_run(plan, [KEY] * 3, _t(Xtr),
                                 torch.from_numpy(ctr), session_bits=caps,
                                 source=sources)
    for s, cap in enumerate(caps):
        jplan = JC.plan_for([JLogistic(steps=30) for _ in Xtr], k,
                            max_rounds=3, budget=JBudgetSpec(
                                session_bits=cap, ladder=jladder))
        single = JC.compiled_session(jplan, jax.random.key(KEY), _j(Xtr),
                                     jnp.asarray(ctr))
        for field in ("executed", "valid", "sent", "codec_idx",
                      "exhausted"):
            np.testing.assert_array_equal(getattr(sweep, field)[s].numpy(),
                                          np.asarray(getattr(single, field)))
        np.testing.assert_allclose(sweep.alphas[s].numpy(),
                                   np.asarray(single.alphas), rtol=1e-5)


def test_control_sweep_needs_a_control_plane(blob):
    Xtr, ctr, _, _, k = blob
    plan = TC.plan_for([TLogistic(steps=10, device=CPU) for _ in Xtr], k,
                       max_rounds=2)
    with pytest.raises(ValueError, match="neither"):
        TC.control_sweep_run(plan, [KEY], _t(Xtr), torch.from_numpy(ctr))


def test_control_sweep_live_matches_dark(blob):
    """tests/test_telemetry_live.py's pin: live = dark, one round tap a
    (config, executed round), the tight config's rounds after it ran dry
    dropped by the sink, a round's taps one copy."""
    Xtr, ctr, _, _, k = blob
    plan = TC.plan_for([TLogistic(steps=30, device=CPU) for _ in Xtr], k,
                       max_rounds=2,
                       budget=TBudgetSpec(session_bits=600_000))
    Xs, c = _t(Xtr), torch.from_numpy(ctr)
    bits = [40_000, 600_000]
    dark = TC.control_sweep_run(plan, [5, 6], Xs, c, session_bits=bits)
    sink = LiveSink(MetricsRegistry())
    with installed(sink):
        live = TC.control_sweep_run(plan, [5, 6], Xs, c, session_bits=bits,
                                    live=True)
    for field in RESULT_FIELDS:
        assert torch.equal(getattr(live, field), getattr(dark, field))
    assert sink.copies == plan.max_rounds
    assert sink.registry.total("live_rounds_total") == \
        int(dark.executed.any(-1).sum())
    assert int(dark.executed.any(-1).sum()) < 4       # the tight one ran dry


# ====================================================== the device qmax op
def _payload(rows, n, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((rows, n)).astype(
        np.float32)), torch.from_numpy(rng.random((rows, n),
                                                  dtype=np.float32)))


@pytest.mark.parametrize("n", [2048, 1000, 1])
def test_rows_qmax_plain_equals_lone_calls(n):
    x, u = _payload(3, n, n)
    qmax = torch.tensor(QMAXES)
    got = tq.quantize_dequant_rows(x, u, qmax)
    assert all(torch.equal(a, b) for a, b in zip(
        got, tq.quantize_dequant_rows_plain(x, u, qmax)))
    for s, qm in enumerate(QMAXES):
        lone = tq.quantize_dequant_tiles(x[s], u[s], qm)
        for g, w in zip(got, lone):
            assert torch.equal(g[s], w), (s, qm)
    # a 0-d range is every row's
    shared = tq.quantize_dequant_rows(x, u, torch.tensor(31.0))
    assert torch.equal(shared[0], tq.quantize_dequant_rows(x, u, 31.0)[0])


def test_block_rows_qmax_plain_equals_lone_calls():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 1024, 2)).astype(np.float32))
    u = torch.from_numpy(rng.random((3, 1024, 2), dtype=np.float32))
    got = tq.quantize_dequant_block_rows(x, u, torch.tensor(QMAXES))
    for s, qm in enumerate(QMAXES):
        for g, w in zip(got, tq.quantize_dequant_block(x[s], u[s], qm)):
            assert torch.equal(g[s], w), s


def test_qmax_ops_vmap_rule_batched_and_unbatched_range():
    x, u = _payload(3, 2048, 5)
    qmax = torch.tensor(QMAXES)
    batched = torch.func.vmap(lambda x, u, q: ops.quantize_dequant(x, u, q))(
        x, u, qmax)
    shared = torch.func.vmap(lambda x, u: ops.quantize_dequant(
        x, u, torch.tensor(7.0)))(x, u)
    one = ops.quantize_dequant(x[1], u[1], torch.tensor(31.0))
    for s, qm in enumerate(QMAXES):
        lone = tq.quantize_dequant_tiles(x[s], u[s], qm)
        seven = tq.quantize_dequant_tiles(x[s], u[s], 7.0)
        for g, sh, w, w7 in zip(batched, shared, lone, seven):
            assert torch.equal(g[s], w) and torch.equal(sh[s], w7)
    for g, w in zip(one, tq.quantize_dequant_tiles(x[1], u[1], 31.0)):
        assert torch.equal(g, w)
    blocks = x.reshape(3, 1024, 2)
    bu = u.reshape(3, 1024, 2)
    got = torch.func.vmap(lambda x, u, q: ops.quantize_dequant_block(
        x, u, q))(blocks, bu, qmax)
    for s, qm in enumerate(QMAXES):
        assert torch.equal(got[0][s],
                           tq.quantize_dequant_block(blocks[s], bu[s],
                                                     qm)[0])


def test_qmax_ops_fake_implementations():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        xhat, q, scales = ops._quantize_dequant_qmax_op(
            torch.empty(3072), torch.empty(3072), torch.empty(()), 1024)
        assert (tuple(xhat.shape), q.dtype, tuple(scales.shape)) == \
            ((3072,), torch.int8, (3,))
        xhat, q, scales = ops._quantize_dequant_block_qmax_op(
            torch.empty((4500, 2)), torch.empty((4500, 2)), torch.empty(()),
            1024)
        assert (tuple(xhat.shape), q.dtype, tuple(scales.shape)) == \
            ((4500, 2), torch.int8, (1,))


def test_rows_qmax_checks_its_range_operand():
    x, u = _payload(3, 64, 1)
    for bad, err in ((torch.tensor([127, 31, 7]), TypeError),
                     (torch.tensor(QMAXES).double(), TypeError),
                     (torch.tensor(QMAXES[:2]), ValueError),
                     (torch.tensor([QMAXES]), ValueError)):
        with pytest.raises(err):
            tq.quantize_dequant_rows(x, u, bad)


# ---------------------------------------------- the card path, stood in
class _FakeLib:
    """Records the C calls a wrapper makes and reports success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(tq, "on_card", lambda x, what: True)
    monkeypatch.setattr(tq, "_lib", lambda: lib)
    monkeypatch.setattr(tq, "current", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(tq, "raw_stream", lambda device: 7)
    monkeypatch.setattr(tq, "cluster_limit", lambda index: 16)
    return lib


@pytest.mark.parametrize("rows,n", [(3, 15000), (3, 2048), (2, 2 ** 19)])
def test_rows_qmax_is_one_call_with_the_range_pointer(fake_card, rows, n):
    """One C call on the flat payload in each row's tiles, the ranges'
    pointer and the tiles a row beside them (the large route above
    LARGE_TILE), counted once under the float route's counter."""
    x, u = _payload(rows, n, 2)
    qmax = torch.tensor(QMAXES[:rows])
    before = tq.quantize_dequant_tiles.launches
    tq.quantize_dequant_rows(x, u, qmax)
    (name, args), = fake_card.calls
    tile = tq.tile_for(n)
    p = tq.plan(tile, 16)
    if p.route == "large":
        assert name == "quantize_dequant_qmax_large"
        assert args[6:8] == (rows * n, tile)
        assert args[8:] == (qmax.data_ptr(), n // tile, 7)
    else:
        assert name == "quantize_dequant_qmax"
        assert args[5:9] == (rows * n, tile, p.cluster, p.per_cta)
        assert args[9:] == (qmax.data_ptr(), n // tile, 7)
    assert tq.quantize_dequant_tiles.launches == before + 1


def test_block_rows_qmax_is_one_call(fake_card):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 1024, 2)).astype(np.float32))
    u = torch.from_numpy(rng.random((8, 1024, 2), dtype=np.float32))
    qmax = torch.arange(1.0, 9.0) * 15
    before = tq.quantize_dequant_block_rows.launches
    tq.quantize_dequant_block_rows(x, u, qmax)
    (name, args), = fake_card.calls
    tile = tq.rows_for(1024, 2) * 2
    assert name == "quantize_dequant_qmax"
    assert args[5:7] == (8 * 1024 * 2, tile)
    assert args[9:] == (qmax.data_ptr(), 1024 * 2 // tile, 7)
    assert tq.quantize_dequant_block_rows.launches == before + 1


def test_scalar_route_is_unchanged(fake_card):
    """The plain codec path still passes qmax and its reciprocal by value
    to the scalar entry point."""
    x, u = _payload(1, 2048, 3)
    tq.quantize_dequant_tiles(x[0], u[0], 7.0)
    (name, args), = fake_card.calls
    assert name == "quantize_dequant"
    assert args[9:] == (7.0, tq.inv_qmax(7.0), 7)

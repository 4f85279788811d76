"""The compiled backend's last pieces on the card (skips without a card; no
JAX here): the quantize kernels' device-qmax routes against their plain
versions and against lone launches at the float range, a codec sweep's
rows against the per-config compiled sessions, a control sweep's rows
against the static compiles, and the compiled async session against the
eager one, each bit for bit on the card."""
import numpy as np
import pytest
import torch

from repro_torch.comm import BudgetedTransport, BudgetSpec
from repro_torch.comm import codecs as tcodecs
from repro_torch.core import compiled as TC
from repro_torch.core import engine as T
from repro_torch.kernels import quantize as tq
from repro_torch.learners.logistic import LogisticRegression

K, AGENTS = 4, 3
QMAXES = [127.0, 31.0, 7.0]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cohort(dev):
    gen = torch.Generator().manual_seed(1)
    centers = torch.rand((K, 2 * AGENTS), generator=gen) * 20 - 10
    classes = torch.randint(0, K, (300,), generator=gen)
    X = centers[classes] + 1.2 * torch.randn((300, 2 * AGENTS),
                                             generator=gen)
    return ([X[:, 2 * m:2 * m + 2].to(dev) for m in range(AGENTS)],
            classes.to(dev))


@pytest.mark.gpu
def test_qmax_routes_equal_plain_on_card():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, qm in (((3, 15000), QMAXES), ((3, 2 ** 19 + 3), QMAXES),
                      ((3, 4500, 2), QMAXES),
                      ((8, 1024, 2), [127.0 - 15 * i for i in range(8)])):
        x = torch.randn(shape, generator=gen, device=dev)
        u = torch.rand(shape, generator=gen, device=dev)
        qmax = torch.tensor(qm, device=dev)
        route = (tq.quantize_dequant_rows if len(shape) == 2
                 else tq.quantize_dequant_block_rows)
        plain = (tq.quantize_dequant_rows_plain if len(shape) == 2
                 else tq.quantize_dequant_block_rows_plain)
        lone = (tq.quantize_dequant_tiles if len(shape) == 2
                else tq.quantize_dequant_block)
        got = route(x, u, qmax)
        again = route(x, u, qmax)
        for g, a, p in zip(got, again, plain(x, u, qmax)):
            assert torch.equal(g, a) and torch.equal(g, p), shape
        for s, q in enumerate(qm):
            for g, w in zip(got, lone(x[s], u[s], q)):
                assert torch.equal(g[s], w), (shape, s)


def _plan(bits, learners, **kw):
    return TC.plan_for(learners, K, max_rounds=3,
                       codec=tcodecs.QuantCodec(bits=bits), **kw)


@pytest.mark.gpu
def test_sweeps_equal_per_config_runs_on_card():
    dev = _card()
    Xs, c = _cohort(dev)
    learners = [LogisticRegression(steps=25, device=dev)
                for _ in range(AGENTS)]
    sweep = TC.quant_sweep_run(_plan(8, learners), [2] * 3, Xs, c, QMAXES)
    for s, bits in enumerate((8, 6, 4)):
        single = TC.compiled_session(_plan(bits, learners), 2, Xs, c)
        for field in ("alphas", "w", "w_trace", "sent", "codec_idx"):
            assert torch.equal(getattr(sweep, field)[s],
                               getattr(single, field)), (bits, field)
    caps = [60_000, 30_000, None]
    plan = TC.plan_for(learners, K, max_rounds=3,
                       budget=BudgetSpec(session_bits=caps[0]))
    ctrl = TC.control_sweep_run(plan, [2] * 3, Xs, c, session_bits=caps)
    for s, cap in enumerate(caps):
        single = TC.compiled_session(TC.plan_for(
            learners, K, max_rounds=3, budget=BudgetSpec(session_bits=cap)),
            2, Xs, c)
        for field in ("alphas", "w", "sent", "codec_idx", "exhausted"):
            assert torch.equal(getattr(ctrl, field)[s],
                               getattr(single, field)), (cap, field)


@pytest.mark.gpu
@pytest.mark.parametrize("channel", ["plain", "int8", "budget"])
def test_async_compiled_equals_eager_on_card(channel):
    dev = _card()
    Xs, c = _cohort(dev)
    out = {}
    for backend in ("eager", "compiled"):
        transport = {"plain": lambda: T.MeteredTransport(),
                     "int8": lambda: T.MeteredTransport(
                         codec=tcodecs.QuantCodec(8)),
                     "budget": lambda: BudgetedTransport(BudgetSpec(
                         session_bits=45_000))}[channel]()
        proto = T.Protocol(T.SessionConfig(num_classes=K, max_rounds=4),
                           scheduler=T.AsyncStaleScheduler(),
                           transport=transport, backend=backend, device=dev)
        fit = proto.fit(5, T.endpoints_for(
            [LogisticRegression(steps=25, device=dev) for _ in Xs], Xs), c)
        out[backend] = (fit, proto._session.state.w, transport.log.entries,
                        proto.predict_distributed(Xs))
    (ef, ew, el, ep), (cf, cw, cl, cp) = out["eager"], out["compiled"]
    assert [(x.agent, x.round, x.alpha) for x in cf.components] == \
        [(x.agent, x.round, x.alpha) for x in ef.components]
    assert torch.equal(cw, ew) and cl == el and torch.equal(cp, ep)
    assert np.isfinite(cw.cpu().numpy()).all()

"""Telemetry on the card against the same run without it and on the CPU
(skips without a card; no JAX here): a compiled int8 session on the blob
with live telemetry makes the dark run's w, ledger and kernel launches,
and its counters are the CPU run's."""
import pytest
import torch

from repro_torch.comm.codecs import QuantCodec
from repro_torch.core import engine as T
from repro_torch.data.partition import train_test_split, vertical_split
from repro_torch.data.synthetic import blob_fig3
from repro_torch.learners.logistic import LogisticRegression
from repro_torch.telemetry import Telemetry


def _run(device, tele):
    from repro_torch.kernels import ignorance, quantize
    ds = blob_fig3(torch.Generator().manual_seed(0), n=240, device=device)
    tr, _ = train_test_split(0, 240)
    tr = torch.as_tensor(tr, device=device)
    Xtr = [x[tr] for x in vertical_split(ds.X, ds.splits)]
    ignorance.ignorance_update.launches = 0
    quantize.quantize_dequant_tiles.launches = 0
    proto = T.Protocol(T.SessionConfig(num_classes=ds.num_classes,
                                       max_rounds=3),
                       transport=T.MeteredTransport(codec=QuantCodec(8)),
                       backend="compiled", telemetry=tele, device=device)
    proto.fit(7, T.endpoints_for([LogisticRegression(steps=40, device=device)
                                  for _ in Xtr], Xtr), ds.classes[tr])
    return (proto._compiled_result.w.cpu(), proto.transport.log.entries,
            (ignorance.ignorance_update.launches,
             quantize.quantize_dequant_tiles.launches))


@pytest.mark.gpu
def test_telemetry_on_equals_off_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lit_tele, cpu_tele = Telemetry(live=True), Telemetry(live=True)
    lit = _run("cuda", lit_tele)
    dark = _run("cuda", None)
    _run("cpu", cpu_tele)
    assert torch.equal(lit[0], dark[0]) and lit[1] == dark[1]
    assert lit[2] == dark[2] and lit[2][0] > 0
    counters = [{n: t.registry.series(n) for n in t.registry.counter_names()}
                for t in (lit_tele, cpu_tele)]
    assert counters[0] == counters[1]
    reg = lit_tele.registry
    assert reg.total("live_wire_bits_total") == reg.total("wire_bits_total")
    assert lit_tele.live.copies == 3        # one tap copy a round
    assert lit_tele.tracer.well_formed()

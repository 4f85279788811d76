"""The port's protocol variants on the card against the same run on the
CPU (skips without a card; no JAX here): FedAvg, eager and its one
program, and Assisted Learning, on a small cohort under the int8 codec
and a churning scenario.  Ledgers are exact; FedAvg's g within 1e-4 (the
card's float32 reductions sum in another order and AdamW's warm starts
carry that, ROADMAP Queue 3), AL's ridge blocks within 1e-5; the card's
one-program FedAvg equals its eager FedAvg bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch.comm import codecs as tcodecs
from repro_torch.core import engine as T
from repro_torch.learners.logistic import LogisticRegression
from repro_torch.scenarios import AssistedLearningVariant, FedAvgVariant
from repro_torch.scenarios import Scenario

K, AGENTS = 4, 3


def _cohort():
    gen = torch.Generator().manual_seed(1)
    centers = torch.rand((K, 2 * AGENTS), generator=gen) * 20 - 10
    classes = torch.randint(0, K, (60,), generator=gen)
    X = centers[classes] + 1.2 * torch.randn((60, 2 * AGENTS), generator=gen)
    return ([X[:, 2 * m:2 * m + 2].numpy() for m in range(AGENTS)],
            classes.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("protocol", ["fedavg", "al"])
def test_variants_on_card_equal_cpu(protocol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    Xs, c = _cohort()
    scenario = Scenario("mix", subsample=0.9, straggle=0.2, seed=5)
    results = {}
    for dev in ("cpu", "cuda"):
        for backend in (("eager", "compiled") if protocol == "fedavg"
                        else ("eager",)):
            tt = T.MeteredTransport(codec=tcodecs.make_codec("int8"))
            learner = LogisticRegression(steps=25, device=dev)
            fit = T.Protocol(
                T.SessionConfig(num_classes=K, max_rounds=4), transport=tt,
                variant=(FedAvgVariant() if protocol == "fedavg"
                         else AssistedLearningVariant()),
                scenario=scenario, device=dev, backend=backend).fit(
                3, T.endpoints_for([learner for _ in Xs],
                                   [torch.from_numpy(x) for x in Xs]),
                torch.from_numpy(c))
            results[dev, backend] = (fit, tt)
    cpu_fit, cpu_t = results["cpu", "eager"]
    for (dev, backend), (fit, tt) in results.items():
        assert tt.log.entries == cpu_t.log.entries
        if protocol == "fedavg":
            np.testing.assert_allclose(fit.g.cpu().numpy(),
                                       cpu_fit.g.numpy(), atol=1e-4)
        else:
            for a, b in zip(fit.components, cpu_fit.components):
                np.testing.assert_allclose(a.params.cpu().numpy(),
                                           b.params.numpy(), atol=1e-5)
    if protocol == "fedavg":
        assert torch.equal(results["cuda", "compiled"][0].g,
                           results["cuda", "eager"][0].g)

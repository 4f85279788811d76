"""Fig. 4b/5 scenario: two agents each hold HALF of every image
(left/right) and assist each other with 3-layer neural networks -- the
paper's privacy-motivated Fashion-MNIST setup, on the offline surrogate,
driven by the port's engine on the card with a byte-metered transport and
a mid-run checkpoint.

Counterpart of ``examples/fashion_halves_nn.py``.

Run:  PYTHONPATH=src python examples_torch/fashion_halves_nn.py [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.comm.draws import ChannelDraws
from repro_torch.core.engine import (MeteredTransport, Protocol,
                                     SessionConfig, endpoints_for)
from repro_torch.core.protocol import ASCIIConfig, fit_single_agent_adaboost
from repro_torch.core.transport import oracle_bits
from repro_torch.data.partition import train_test_split, vertical_split
from repro_torch.data.synthetic import fashion_surrogate
from repro_torch.learners.mlp import MLP

# the sessions' keys: ASCII, the single agent, the oracle
SEEDS = (1, 2, 3)


def learners(device) -> dict:
    """The halves' networks, and the oracle's."""
    return {"agents": [MLP(hidden=(128, 64), steps=200, device=device),
                       MLP(hidden=(128, 64), steps=200, device=device)],
            "oracle": MLP(hidden=(128, 64), steps=200, device=device)}


def run(ds, learners: dict, draws: dict, device) -> list[str]:
    """The example on ``ds`` (a Dataset on ``device``): the printed lines.
    ``draws`` maps each of :data:`SEEDS` to its session's draw source."""
    tr, te = (torch.as_tensor(i, device=ds.X.device)
              for i in train_test_split(0, ds.X.shape[0]))
    Xs = vertical_split(ds.X, ds.splits)
    Xtr, Xte = [x[tr] for x in Xs], [x[te] for x in Xs]
    ctr, cte = ds.classes[tr], ds.classes[te]

    agents = learners["agents"]
    transport = MeteredTransport()
    engine = Protocol(SessionConfig(num_classes=10, max_rounds=4),
                      transport=transport, device=device, draws=draws[1])
    session = engine.start(1, endpoints_for(agents, Xtr), ctr)
    session.run(max_rounds=2)
    with tempfile.TemporaryDirectory() as ckpt:
        session.checkpoint(ckpt)        # mid-run SessionState to disk ...
        session = engine.resume(        # ... picked up by a fresh session,
            ckpt, endpoints_for(agents, Xtr), ctr)  # as after a crash
        session.run()
        lines = [f"checkpointed at round 2, resumed, finished at round "
                 f"{session.state.round}"]
    fitted = session.fitted()
    acc = float((fitted.predict(Xte) == cte).float().mean())

    cfg = ASCIIConfig(num_classes=10, max_rounds=4)
    single = fit_single_agent_adaboost(2, Xtr[0], ctr, agents[0], cfg,
                                       device=device, draws=draws[2])
    acc_single = float((single.predict([Xte[0]]) == cte).float().mean())
    oracle = fit_single_agent_adaboost(3, torch.cat(Xtr, 1), ctr,
                                       learners["oracle"], cfg,
                                       device=device, draws=draws[3])
    acc_oracle = float((oracle.predict([torch.cat(Xte, 1)]) == cte
                        ).float().mean())
    ratio = oracle_bits(len(tr), Xs[1].shape[1]) / max(transport.total_bits,
                                                        1)
    return lines + [f"ASCII (half-image A + B assist): {acc:.3f}",
                    f"Single (left half only)        : {acc_single:.3f}",
                    f"Oracle (whole images pulled)   : {acc_oracle:.3f}",
                    f"transmission reduction vs shipping B's pixels: "
                    f"{ratio:.0f}x"]


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    ds = fashion_surrogate(torch.Generator().manual_seed(5), n=1500,
                           device=device)
    lines = run(ds, learners(device), {s: ChannelDraws() for s in SEEDS},
                device)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()

"""Quickstart: two-agent ASCII on Gaussian blobs (paper Fig. 1 scenario),
on the port's agent-session engine, on the card.

Counterpart of ``examples/quickstart.py``.  Agent A holds features 0-1,
agent B holds features 2-7; both see the labels.  B assists A by
interchanging ignorance scores only: no raw data moves.  Each agent is an
AgentEndpoint; the byte-metered transport books every message.  The
ignorance update of every hop runs the CUDA kernel on the card.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.comm.draws import ChannelDraws
from repro_torch.core.engine import (AgentEndpoint, MeteredTransport,
                                     Protocol, SessionConfig)
from repro_torch.core.protocol import ASCIIConfig, fit_single_agent_adaboost
from repro_torch.core.transport import oracle_bits
from repro_torch.data.partition import train_test_split, vertical_split
from repro_torch.data.synthetic import blob_fig3
from repro_torch.learners.tree import DecisionTree

# the sessions' keys: ASCII, the single agent, the oracle
SEEDS = (1, 2, 3)


def learners(device) -> dict:
    """Agent A's and B's trees, and the oracle's."""
    return {"agents": [DecisionTree(depth=4, device=device),
                       DecisionTree(depth=4, device=device)],
            "oracle": DecisionTree(depth=4, device=device)}


def run(ds, learners: dict, draws: dict, device) -> list[str]:
    """The example on ``ds`` (a Dataset on ``device``): the printed lines.
    ``draws`` maps each of :data:`SEEDS` to its session's draw source."""
    tr, te = (torch.as_tensor(i, device=ds.X.device)
              for i in train_test_split(0, ds.X.shape[0]))
    Xs = vertical_split(ds.X, (2, 6))            # two agents
    Xtr, Xte = [x[tr] for x in Xs], [x[te] for x in Xs]
    ctr, cte = ds.classes[tr], ds.classes[te]

    agents = learners["agents"]
    endpoints = [AgentEndpoint(0, agents[0], Xtr[0]),
                 AgentEndpoint(1, agents[1], Xtr[1])]
    transport = MeteredTransport()
    engine = Protocol(SessionConfig(num_classes=ds.num_classes,
                                    max_rounds=10),
                      transport=transport, device=device, draws=draws[1])
    session = engine.start(1, endpoints, ctr)
    session.run()
    fitted = session.fitted()

    acc = float((fitted.predict(Xte) == cte).float().mean())
    cfg = ASCIIConfig(num_classes=ds.num_classes, max_rounds=10)
    single = fit_single_agent_adaboost(2, Xtr[0], ctr, endpoints[0].learner,
                                       cfg, device=device, draws=draws[2])
    acc_single = float((single.predict([Xte[0]]) == cte).float().mean())
    oracle = fit_single_agent_adaboost(3, torch.cat(Xtr, 1), ctr,
                                       learners["oracle"], cfg,
                                       device=device, draws=draws[3])
    acc_oracle = float((oracle.predict([torch.cat(Xte, 1)]) == cte
                        ).float().mean())

    lines = [f"rounds run            : {fitted.num_rounds}",
             f"ASCII  (A assisted)   : {acc:.3f}",
             f"Single (A alone)      : {acc_single:.3f}",
             f"Oracle (pulled data)  : {acc_oracle:.3f}",
             f"bits interchanged     : {transport.total_bits:,} "
             f"(vs {oracle_bits(len(tr), 6):,} to ship B's raw features)"]
    for t, h in enumerate(fitted.history[:3]):
        lines.append(f"round {t}: alphas={['%.2f' % a for a in h['alphas']]}"
                     f" weighted_acc={['%.2f' % a for a in h['accs']]}")
    return lines


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    ds = blob_fig3(torch.Generator().manual_seed(0), n=1000, device=device)
    lines = run(ds, learners(device), {s: ChannelDraws() for s in SEEDS},
                device)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()

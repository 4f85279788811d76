"""The paper's model-free claim (Section I contribution 2): agents keep
*private, heterogeneous* model classes -- here a decision tree, a logistic
regression and a 3-layer NN cooperate in one session of the port's engine
on the card; only ignorance scores and model weights ever cross endpoint
boundaries.  Uses the paper's CV stop criterion via an explicit validation
holdout.

Counterpart of ``examples/heterogeneous_agents.py``.

Run:  PYTHONPATH=src python examples_torch/heterogeneous_agents.py [--device cpu]
"""
import argparse

import torch

from repro_torch.comm.draws import ChannelDraws
from repro_torch.core.engine import (Protocol, SessionConfig, endpoints_for,
                                     holdout_split)
from repro_torch.core.protocol import ASCIIConfig, fit_single_agent_adaboost
from repro_torch.data.partition import train_test_split, vertical_split
from repro_torch.data.synthetic import blob_fig3
from repro_torch.learners.logistic import LogisticRegression
from repro_torch.learners.mlp import MLP
from repro_torch.learners.tree import DecisionTree

# the sessions' keys: ASCII, the single agent
SEEDS = (1, 2)


def learners(device) -> list:
    return [DecisionTree(depth=4, device=device),          # agent A: trees
            LogisticRegression(steps=200, device=device),  # B: linear model
            MLP(hidden=(64, 32), steps=200, device=device)]  # C: neural net


def run(ds, learners: list, draws: dict, device) -> list[str]:
    """The example on ``ds`` (a Dataset on ``device``): the printed lines.
    ``draws`` maps each of :data:`SEEDS` to its session's draw source."""
    tr, te = (torch.as_tensor(i, device=ds.X.device)
              for i in train_test_split(0, ds.X.shape[0]))
    Xs = vertical_split(ds.X, (2, 3, 3))
    Xtr, Xte = [x[tr] for x in Xs], [x[te] for x in Xs]
    ctr, cte = ds.classes[tr], ds.classes[te]

    # the paper's CV stop (Section III-C): hold out trailing rows
    Xfit, cfit, Xval, cval = holdout_split(Xtr, ctr, 0.2)
    engine = Protocol(SessionConfig(num_classes=10, max_rounds=8,
                                    cv_patience=2), device=device,
                      draws=draws[1])
    session = engine.start(1, endpoints_for(learners, Xfit), cfit,
                           validation=(Xval, cval))
    session.run()
    fitted = session.fitted()
    acc = float((fitted.predict(Xte) == cte).float().mean())

    cfg = ASCIIConfig(num_classes=10, max_rounds=8, cv_fraction=0.2,
                      cv_patience=2)
    single = fit_single_agent_adaboost(2, Xtr[0], ctr, learners[0], cfg,
                                       device=device, draws=draws[2])
    acc_single = float((single.predict([Xte[0]]) == cte).float().mean())

    lines = ["agents: tree(2 feats) + logistic(3) + MLP(3), CV stop "
             "criterion",
             f"rounds run (CV-stopped): {fitted.num_rounds}"]
    for t, h in enumerate(fitted.history):
        if "val_acc" in h:
            lines.append(f"  round {t}: val_acc={h['val_acc']:.3f}")
    lines += [f"ASCII (heterogeneous)  : {acc:.3f}",
              f"Single (tree agent A)  : {acc_single:.3f}"]
    return lines


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    ds = blob_fig3(torch.Generator().manual_seed(3), n=900, device=device)
    lines = run(ds, learners(device), {s: ChannelDraws() for s in SEEDS},
                device)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()

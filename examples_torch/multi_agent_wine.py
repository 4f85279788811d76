"""Multi-agent chain (Section IV): 11 agents each holding ONE wine
feature, decision-tree learners, comparing the chain order against
ASCII-Random, ASCII-Simple, Ensemble-AdaBoost and the beyond-paper
ASCII-Async, all through the port's engine on the card, where each variant
is just a Scheduler + alpha policy.

Counterpart of ``examples/multi_agent_wine.py``.

Run:  PYTHONPATH=src python examples_torch/multi_agent_wine.py [--device cpu]
"""
import argparse

import torch

from repro_torch.comm.draws import ChannelDraws
from repro_torch.core.engine import (Protocol, SessionConfig, endpoints_for,
                                     variant_setup)
from repro_torch.core.protocol import ASCIIConfig, fit_ensemble_adaboost
from repro_torch.data.partition import train_test_split, vertical_split
from repro_torch.data.synthetic import wine_surrogate
from repro_torch.learners.tree import DecisionTree

VARIANTS = ("ascii", "simple", "random", "async")
# the sessions' keys: every variant's, the ensemble's
SEEDS = (1, 2)
SPLITS = tuple([1] * 11)


def learners(device) -> list:
    """One tree an agent."""
    return [DecisionTree(depth=3, num_thresholds=8, device=device)
            for _ in SPLITS]


def run(ds, learners: list, draws: dict, device) -> list[str]:
    """The example on ``ds`` (a Dataset on ``device``): the printed lines.
    ``draws`` maps each of :data:`SEEDS` to its sessions' draw source (the
    ensemble's members draw from their own keys)."""
    tr, te = (torch.as_tensor(i, device=ds.X.device)
              for i in train_test_split(0, ds.X.shape[0]))
    Xs = vertical_split(ds.X, SPLITS)
    Xtr, Xte = [x[tr] for x in Xs], [x[te] for x in Xs]
    ctr, cte = ds.classes[tr], ds.classes[te]

    lines = []
    for variant in VARIANTS:
        scheduler, upstream = variant_setup(variant)
        engine = Protocol(SessionConfig(num_classes=ds.num_classes,
                                        max_rounds=6, upstream=upstream),
                          scheduler=scheduler, device=device,
                          draws=draws[1])
        fitted = engine.fit(1, endpoints_for(learners, Xtr), ctr)
        acc = float((fitted.predict(Xte) == cte).float().mean())
        lines.append(f"{variant:12s} acc={acc:.3f} "
                     f"rounds={fitted.num_rounds} "
                     f"components={len(fitted.components)}")

    cfg = ASCIIConfig(num_classes=ds.num_classes, max_rounds=6)
    ens = fit_ensemble_adaboost(2, Xtr, ctr, learners, cfg, device=device)
    acc = float((ens.predict(Xte) == cte).float().mean())
    lines.append(f"{'ensemble_ada':12s} acc={acc:.3f} (no interchange)")
    return lines


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    ds = wine_surrogate(torch.Generator().manual_seed(0), device=device)
    lines = run(ds, learners(device), {s: ChannelDraws() for s in SEEDS},
                device)
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()

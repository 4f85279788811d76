#!/usr/bin/env python3
"""Where a vmapped fleet's MLP fit parts from the single fit, on the card.

    python3 tools/fleet_fit_bits.py [--sessions 8] [--steps 1,2,5,20]

The Fashion-MNIST surrogate's first half (42000 rows of 392 pixels, the
uniform ignorance vector) and the paper's MLP(128, 64): for each of F
session keys, the fit's init from ``ChannelDraws().fit(key, 0, 0)``, then
the same fit run alone and inside ``torch.func.vmap`` over the F inits (the
data shared, as ``core.compiled.fleet_run`` runs a seed fleet).  Prints one
JSON object: for each op stage (the forward's logits, the gradient at the
init and which of its leaves, the params after each step count) the
sessions whose batched result differs from the single one, and whether
two runs of the single fit, and of the batched one, give the same bits.
It needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--steps", default="1,2,5,20")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fleet_fit_bits: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.comm.draws import ChannelDraws
    from repro_torch.core.engine import key_data
    from repro_torch.data.partition import train_test_split, vertical_split
    from repro_torch.data.synthetic import fashion_surrogate
    from repro_torch.learners import mlp
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    ds = fashion_surrogate(torch.Generator().manual_seed(0), n=60000,
                           device=dev)
    tr, _ = train_test_split(0, ds.X.shape[0])
    X = vertical_split(ds.X, ds.splits)[0][torch.as_tensor(tr, device=dev)]
    c = ds.classes[torch.as_tensor(tr, device=dev)]
    n, k = X.shape[0], 10
    onehot = (c[:, None] == torch.arange(k, device=dev)).float()
    w = torch.full((n,), 1.0 / n, device=dev)
    F = args.sessions
    inits = [mlp.MLPCore(k, (128, 64), 1, device=dev).init(
        ChannelDraws().fit(key_data(f), 0, 0), (X.shape[1],))
        for f in range(F)]
    stacked = [{key: torch.stack([p[i][key] for p in inits])
                for key in inits[0][i]} for i in range(len(inits[0]))]

    def tree(params):
        return {str(i): layer for i, layer in enumerate(params)}

    def differs(single, batched):
        """Sessions whose batched leaves are not the single's bits."""
        out = []
        for f in range(F):
            same = all(torch.equal(a, b[f]) for a, b in zip(
                _leaves(single[f]), _leaves(batched)))
            if not same:
                out.append(f)
        return out

    report = {"card": torch.cuda.get_device_name(0), "sessions": F,
              "torch": torch.__version__}
    logits1 = [mlp.forward(p, X) for p in inits]
    logitsb = torch.func.vmap(lambda p: mlp.forward(p, X))(stacked)
    report["forward"] = differs(logits1, logitsb)
    grad = torch.func.grad(mlp._weighted_ce)
    g1 = [grad(tree(p), X, onehot, w) for p in inits]
    gb = torch.func.vmap(lambda p: grad(tree(p), X, onehot, w))(stacked)
    report["grad_at_init"] = differs(g1, gb)
    names = [f"{i}.{key}" for i, layer in enumerate(inits[0])
             for key in layer]
    report["grad_leaves_that_differ"] = {
        f: [name for name, a, b in zip(names, _leaves(g1[f]), _leaves(gb))
            if not torch.equal(a, b[f])] for f in report["grad_at_init"]}
    for steps in [int(s) for s in args.steps.split(",")]:
        core = mlp.MLPCore(k, (128, 64), steps, device=dev)
        single = [core.fit(p, 0, X, onehot, w) for p in inits]
        again = [core.fit(p, 0, X, onehot, w) for p in inits]
        fit = torch.func.vmap(lambda p: core.fit(p, 0, X, onehot, w))
        batched, batched2 = fit(stacked), fit(stacked)
        report[f"after_{steps}_steps"] = {
            "batched_vs_single": differs(single, batched),
            "single_twice_equal": not differs(single, _stack(again)),
            "batched_twice_equal": all(torch.equal(a, b) for a, b in zip(
                _leaves(batched), _leaves(batched2)))}
    print(json.dumps(report))
    return 0


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _stack(trees: list):
    import torch
    from repro_torch.comm.draws import stack_trees
    return stack_trees([_to_list(t) for t in trees]) if trees and not \
        isinstance(trees[0], torch.Tensor) else torch.stack(trees)


def _to_list(t):
    return list(t.values()) if isinstance(t, dict) else t


if __name__ == "__main__":
    sys.exit(main())

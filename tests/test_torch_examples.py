"""The port's examples (``examples_torch/``) against the JAX package's
(``examples/``), line for line.

For each session example the reference's own ``main()`` runs (its file
imported by path, not edited, its stdout captured); then the port's
``run`` gets the reference's dataset (the reference surrogate called here
with the example's key and sizes), the port's learners and the
reference's draws replayed (``ReplayDraws`` of tests/
test_torch_comm_session.py: the MLP's init normals and minibatch rows
from the reference's keys), one a session key of the example.  The
printed lines must agree:

  * every line's text, and its rounds, bits and transmission ratio
    exactly, as the accuracies of tree and logistic agents;
  * an accuracy that an MLP agent takes part in within one test sample
    (1 / rows, plus the two roundings to 3 decimals): ROADMAP Queue 3's
    MLP fits agree within 1e-5, and a held-out sample at a near-tie may
    flip;
  * a tree session's decimals (accuracies, alphas) may part from the
    reference's only where ROADMAP Queue 3's tree caveat parts them: the
    reference's own run records every tree fit, session by session, and
    the port's tree is fitted on each fit's inputs until the first that
    differs, which must be a split that rounding noise decided
    (``_assert_tied_split``); a parted line needs such a session.

``train_lm_100m.py``: with ``launch.train.main`` mocked in both packages,
the arguments each example hands it are equal, for a few command lines.
No 100m step runs here.
"""
import contextlib
import io
import re
import runpy
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro_torch.data.synthetic import Dataset
from test_torch_comm_session import ReplayDraws, _assert_tied_split

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
NUMBER = re.compile(r"\d[\d,]*(?:\.\d+)?")


def _reference_run(name: str):
    """The reference example's printed lines (its ``main()`` run with
    stdout captured) and, for each session it starts, the tree fits it
    ran: (learner, X, classes, w, num_classes, params)."""
    from repro.core import engine as J
    from repro.learners.tree import DecisionTree as JTree
    module = runpy.run_path(str(ROOT / "examples" / f"{name}.py"))
    sessions: list = []
    fit, start = JTree.fit, J.Protocol.start

    def record_fit(self, key, X, classes, w, num_classes):
        params = fit(self, key, X, classes, w, num_classes)
        if not sessions:
            sessions.append([])
        sessions[-1].append((self, X, classes, w, num_classes, params))
        return params

    def record_start(self, *args, **kw):
        sessions.append([])
        return start(self, *args, **kw)
    out = io.StringIO()
    with mock.patch.object(JTree, "fit", record_fit), \
            mock.patch.object(J.Protocol, "start", record_start), \
            contextlib.redirect_stdout(out):
        module["main"]()
    return out.getvalue().splitlines(), sessions


def _noise_partings(sessions: list) -> int:
    """The sessions whose trees part from the port's: in each, the port's
    tree fitted on every recorded fit's inputs until the first whose tree
    differs from the reference's, which must be a split that rounding
    noise decided (ROADMAP Queue 3).  Returns their count."""
    from repro_torch.learners.tree import DecisionTree as TTree
    parted = 0
    for fits in sessions:
        for jl, X, c, w, k, jp in fits:
            X, c, w = (np.array(a) for a in (X, c, w))
            tp = TTree(depth=jl.depth, num_thresholds=jl.num_thresholds,
                       device=CPU).fit(None, torch.from_numpy(X),
                                       torch.from_numpy(c).long(),
                                       torch.from_numpy(w), k)
            if (np.array_equal(np.asarray(jp["feat"]), tp["feat"].numpy())
                    and np.array_equal(np.asarray(jp["leaf"]),
                                       tp["leaf"].numpy())
                    and np.allclose(np.asarray(jp["thr"]), tp["thr"].numpy(),
                                    rtol=1e-6, atol=0)):
                continue
            _assert_tied_split(X, c, w, jp, tp, k, depth=jl.depth,
                               q=jl.num_thresholds)
            parted += 1
            break
    return parted


def _port(name: str) -> dict:
    return runpy.run_path(str(ROOT / "examples_torch" / f"{name}.py"))


def _dataset(jds, splits=None) -> Dataset:
    """The reference's dataset as the port's, on the CPU."""
    return Dataset(jds.name, torch.from_numpy(np.array(jds.X)),
                   torch.from_numpy(np.array(jds.classes)).long(),
                   jds.num_classes, tuple(splits or jds.splits))


def _draws(seeds, agents: dict) -> dict:
    """A ``ReplayDraws`` of each session key: ``agents[seed]`` agents."""
    return {s: ReplayDraws(jax.random.key(s), agents[s]) for s in seeds}


def _quickstart():
    from repro.data.synthetic import blob_fig3
    return (_dataset(blob_fig3(jax.random.key(0), n=1000)), {1: 2, 2: 1, 3: 1},
            {})


def _wine():
    from repro.data.synthetic import wine_surrogate
    return _dataset(wine_surrogate(jax.random.key(0))), {1: 11, 2: 1}, {}


def _heterogeneous():
    from repro.data.synthetic import blob_fig3
    # the ensemble's and the validation's rows with the MLP agent in it:
    # 270 held-out rows, 126 validation rows
    return (_dataset(blob_fig3(jax.random.key(3), n=900)), {1: 3, 2: 1},
            {"ASCII": 270, "val_acc": 126})


def _fashion():
    from repro.data.synthetic import fashion_surrogate
    return (_dataset(fashion_surrogate(jax.random.key(5), n=1500)),
            {1: 2, 2: 1, 3: 1}, {"ASCII": 450, "Single": 450, "Oracle": 450})


EXAMPLES = {"quickstart": _quickstart, "multi_agent_wine": _wine,
            "heterogeneous_agents": _heterogeneous,
            "fashion_halves_nn": _fashion}


def _assert_lines_agree(got: list, want: list, mlp_rows: dict,
                        sessions: list) -> None:
    """``got`` = ``want`` line for line: the text and every integer exact;
    the decimals exact, except on a line named in ``mlp_rows`` (its
    rows: within one sample and the two roundings) and on a tree line
    of an example one of whose sessions parts at a noise-decided split
    (:func:`_noise_partings`)."""
    assert len(got) == len(want), (got, want)
    parted = None
    for g, w in zip(got, want):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        rows = next((n for key, n in mlp_rows.items() if key in w), None)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            if "." not in b or a == b:
                assert a == b, (g, w)
            elif rows is not None:
                assert abs(float(a) - float(b)) <= 1 / rows + 1e-3, (g, w)
            else:
                if parted is None:
                    parted = _noise_partings(sessions)
                assert parted, (g, w)


@contextlib.contextmanager
def _one_thread():
    """torch on one thread: the MLP examples' products oversubscribe the
    cores beside the suite's other workers (Fashion's fits took minutes
    on 8 threads under load; ~28 s on one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_port_example_prints_the_reference_lines(name):
    ds, agents, mlp_rows = EXAMPLES[name]()
    want, sessions = _reference_run(name)
    port = _port(name)
    with _one_thread():
        got = port["run"](ds, port["learners"](CPU),
                          _draws(port["SEEDS"], agents), CPU)
        _assert_lines_agree(got, want, mlp_rows, sessions)


@pytest.mark.parametrize("args", [[], ["--steps", "7"],
                                  ["--steps=9", "--device", "cpu"],
                                  ["--seed", "3"]],
                         ids=["default", "steps", "steps=", "seed"])
def test_train_lm_100m_hands_the_cli_the_reference_arguments(args):
    """Both examples run as scripts with ``args`` on the command line,
    each package's ``launch.train.main`` mocked: the port's receives the
    list the reference's reads from ``sys.argv``."""
    seen = {}

    def ref_main():
        seen["ref"] = sys.argv[1:]

    def port_main(argv):
        seen["port"] = list(argv)
    for pkg, fn in (("repro", ref_main), ("repro_torch", port_main)):
        folder = "examples" if pkg == "repro" else "examples_torch"
        path = str(ROOT / folder / "train_lm_100m.py")
        with mock.patch(f"{pkg}.launch.train.main", fn), \
                mock.patch.object(sys, "argv", [path, *args]):
            runpy.run_path(path, run_name="__main__")
    assert seen["port"] == seen["ref"]
    assert seen["port"][-2:] == ["--preset", "100m"]

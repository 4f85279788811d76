"""The port's import rule: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or the JAX package ``repro``.

One subprocess, whose ``sys.meta_path`` refuses those names, imports every
module of ``repro_torch`` (walked with ``pkgutil``, which imports nothing)
and then ``chip_smoke``, and reports per module whether the import
succeeded and which refused names it asked for.  A subprocess a module
would import torch for each of them; the assertions are one case a module.
"""
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _modules() -> list[str]:
    """Every module and package of ``repro_torch``, then ``chip_smoke``."""
    out = ["repro_torch"]

    def walk(path: Path, prefix: str) -> None:
        for info in pkgutil.iter_modules([str(path)]):
            out.append(prefix + info.name)
            if info.ispkg:
                walk(path / info.name, f"{prefix}{info.name}.")
    walk(SRC / "repro_torch", "repro_torch.")
    return sorted(out) + ["chip_smoke"]


MODULES = _modules()

_CHILD = r'''
import importlib
import importlib.abc
import json
import sys

REFUSED = ("jax", "jaxlib", "repro")
asked = []


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            asked.append(name)
            raise ImportError(f"the port may not import {name}")
        return None


sys.meta_path.insert(0, Refuse())
report = {}
for name in json.loads(sys.argv[1]):
    before = len(asked)
    try:
        importlib.import_module(name)
        error = None
    except BaseException as e:      # report every failure, go on
        error = f"{type(e).__name__}: {e}"
    report[name] = {"error": error, "refused": asked[before:]}
print(json.dumps(report))
'''


@pytest.fixture(scope="module")
def report() -> dict:
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(SRC), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(MODULES)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_walk_finds_the_port():
    for name in ("repro_torch.kernels.quantize", "repro_torch.comm.codecs",
                 "repro_torch.launch.session", "repro_torch.models.api",
                 "repro_torch.train.trainer", "repro_torch.learners.mlp",
                 "repro_torch.learners.forest", "repro_torch.learners.neural",
                 "repro_torch.models.classifier",
                 "repro_torch.control.adaptive",
                 "repro_torch.control.scheduler"):
        assert name in MODULES
    assert not any(m.startswith("repro.") for m in MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax_or_repro(report, module):
    got = report[module]
    assert got["error"] is None, got["error"]
    assert got["refused"] == [], f"{module} asked for {got['refused']}"

"""The dry run ``repro_torch.launch.dryrun`` against the reference's
``repro.launch.dryrun`` and against analytic counts.

  * In a subprocess with a fake world of 8 ranks (data 2, model 4), the
    reduced dense config (qwen3-0.6b's, d 1024, 2 layers, d_ff 2048, vocab
    4096, H 8, KV 4, float32; B 4, S 16): a pair's artifact carries the
    reference's keys (``hlo_ops`` with a null ``fusion``) and the H100's
    constants; the prefill and train steps' flops equal the analytic
    matrix-product count (the flash kernel's 4 D a causal (query, key)
    pair at prefill, the einsum attention's S^2 in training, the backward
    twice the forward), and their collectives, per kind, the Megatron
    count: an all-reduce of [B_loc, S, d] for the embedding and two a
    layer forward (and one a copy_to_model backward) without sequence
    parallelism; with it a reduce-scatter and an all-gather each; the
    vocab-split CE's all-gather of each rank's [2, T] (lse, gold); the
    data-parallel gradient and metric all-reduces.
  * ``model_flops`` and the parameter count equal the reference's
    ``dryrun.model_flops`` and its ``jax.eval_shape`` count for every
    (arch, shape) pair outside ``SKIPS`` (in a JAX subprocess; no
    compile).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from torch_dist_common import JaxReference, ROOT, TESTS

DP, TP, B, S = 2, 4, 4, 16
D, H, KV, HD, F, V, L = 1024, 8, 4, 64, 2048, 4096, 2
BASE = dict(d_model=D, num_layers=L, d_ff=F, vocab_size=V, num_heads=H,
            num_kv_heads=KV, head_dim=HD, dtype="float32", remat="none")

_PORT = """
import json, sys
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import dryrun
from test_torch_dryrun import B, BASE, S

mesh = dryrun.fake_world((2, 4), ("data", "model"))
out = {}
for kind in ("prefill", "train"):
    shape = InputShape(kind, S, B, kind)
    for sp in (False, True):
        cfg = ARCHS["qwen3-0.6b"].reduced().with_overrides(
            **BASE, seq_parallel=sp)
        cost, rec, memory, flash = dryrun.run_step(cfg, shape, mesh)
        out[f"{kind}_{int(sp)}"] = {"cost": cost, "calls": rec.calls,
                                    "bytes": rec.bytes, "flash": flash}
out["artifact"] = dryrun.run_pair(
    "qwen3-0.6b", "train_4k", mesh=mesh, out_dir=sys.argv[1],
    shape=InputShape("train_4k", S, B, "train"), overrides=BASE)
print(json.dumps(out))
"""

_JAX = """
import os
import numpy as np
from repro.configs.base import INPUT_SHAPES
from repro.configs.registry import ARCHS, SKIPS
from repro.launch import dryrun
import jax
out = {}
for arch in ARCHS:
    for name, shape in INPUT_SHAPES.items():
        if (arch, name) in SKIPS:
            continue
        cfg = dryrun.effective_config(arch, shape)
        leaves = jax.tree.leaves(jax.eval_shape(
            lambda: dryrun.api.init_params(jax.random.key(0), cfg)))
        out[f"{arch}|{name}"] = np.asarray(
            [dryrun.model_flops(cfg, shape),
             sum(int(np.prod(x.shape)) for x in leaves)], np.float64)
np.savez(os.environ["OUT"], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    ref = JaxReference(_JAX, tmp / "jax")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)]), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(_PORT),
                           str(tmp / "art")], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), ref.result()


def test_artifact_has_the_references_keys(runs):
    art = runs[0]["artifact"]
    keys = {"arch", "shape", "mesh", "cache_mode", "lower_s", "compile_s",
            "memory", "cost_scanned", "hlo_ops", "cost", "collectives",
            "roofline", "n_chips", "params"}
    assert keys <= set(art)
    assert set(art["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "temp_bytes_bf16_adj"}
    assert set(art["hlo_ops"]) == {"all-gather", "all-reduce",
                                   "reduce-scatter", "all-to-all",
                                   "collective-permute", "fusion"}
    assert art["hlo_ops"]["fusion"] is None
    assert set(art["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "model_flops", "bottleneck"}
    assert art["n_chips"] == DP * TP and art["mesh"] == "2x4"
    assert art["device"]["peak_flops"] == 989e12
    assert art["device"]["hbm_bw"] == 3.35e12
    r = art["roofline"]
    assert r["compute_s"] == art["cost"]["flops"] / 989e12
    assert r["memory_s"] == art["cost"]["bytes"] / 3.35e12
    assert min(art["memory"].values()) > 0
    with open(os.path.join(os.path.dirname(__file__), "..", "src",
                           "repro_torch", "launch", "dryrun.py")) as f:
        assert "197e12" not in f.read()       # no TPU constant


def _forward_flops(flash: bool) -> int:
    """The matrix products of one rank's forward: [T, d] through its heads
    and d_ff slice, the attention, the head over its vocab range."""
    t, b = B // DP * S, B // DP
    h, kv, f, v = H // TP, KV // TP, F // TP, V // TP
    pairs = S * (S + 1) // 2 if flash else S * S
    layer = (2 * t * D * h * HD + 2 * 2 * t * D * kv * HD
             + 4 * b * h * HD * pairs + 2 * t * h * HD * D
             + 3 * 2 * t * D * f)
    return L * layer + 2 * t * D * v


@pytest.mark.parametrize("sp", [0, 1])
def test_flops_equal_the_analytic_count(runs, sp):
    out = runs[0]
    assert out[f"prefill_{sp}"]["flash"] and not out[f"train_{sp}"]["flash"]
    assert out[f"prefill_{sp}"]["cost"]["flops"] == _forward_flops(True)
    assert out[f"train_{sp}"]["cost"]["flops"] == 3 * _forward_flops(False)


def _dp_leaf_bytes() -> list:
    """This rank's gradient leaves (``held_specs``: split over model), one
    data all-reduce each, float32."""
    per_layer = [D, D * H * HD // TP, D * KV * HD // TP, D * KV * HD // TP,
                 H * HD // TP * D, HD, HD, D, D * F // TP, D * F // TP,
                 F // TP * D]
    return [V // TP * D] + [L * n for n in per_layer] + [D]


def _megatron(kind: str, sp: bool) -> dict:
    """(calls, payload bytes) of each kind on one rank, float32."""
    b, t = B // DP, B // DP * S
    x, xs = b * S * D * 4, b * S // TP * D * 4
    ag, ar, rs = [], [], []
    if kind == "prefill":
        if sp:
            ag += [x] * (2 * L + 1)        # attention, MLP, head inputs
            rs += [xs] * (2 * L + 1)       # embedding, attention, MLP outputs
        else:
            ar += [x] * (2 * L + 1)        # embedding, attention, MLP outputs
        ag.append(b * V * 4)               # the last logits, whole vocab
    else:
        if sp:
            ag += [x] * (2 * L + 1) * 2    # forward inputs; RS backward
            rs += [xs] * (2 * L + 1) * 2   # forward outputs; AG backward
            ar += [D * 4] * (2 * L + 1)    # norm scales on S chunks
        else:
            ar += [x] * (2 * L + 1) * 2    # forward; copy_to_model backward
        ar += [HD * 4] * (2 * L)           # the qk norms, used for a share
        ag.append(TP * 2 * t * 4)          # the CE's (lse, gold)
        ar.append(4)                       # the loss normalizer over data
        ar += [n * 4 for n in _dp_leaf_bytes()] + [8]   # grads, metrics
    return {"all-gather": (len(ag), sum(ag)), "all-reduce": (len(ar), sum(ar)),
            "reduce-scatter": (len(rs), sum(rs))}


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("sp", [0, 1])
def test_collectives_equal_the_megatron_count(runs, kind, sp):
    got = runs[0][f"{kind}_{sp}"]
    for k, (calls, nbytes) in _megatron(kind, bool(sp)).items():
        assert (got["calls"][k], got["bytes"][k]) == (calls, nbytes), k
    assert got["calls"]["all-to-all"] == 0


def test_model_flops_and_params_equal_the_references(runs):
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import ARCHS, SKIPS
    from repro_torch.launch import dryrun
    ref = runs[1]
    pairs = [(a, s) for a in ARCHS for s in INPUT_SHAPES
             if (a, s) not in SKIPS]
    assert len(pairs) == len(ref) == 39
    counts = {}
    for arch, name in pairs:
        shape = INPUT_SHAPES[name]
        cfg = dryrun.effective_config(arch, shape)
        if cfg not in counts:
            counts[cfg] = dryrun.count_params(cfg)
        want_flops, want_params = ref[f"{arch}|{name}"]
        assert counts[cfg] == want_params, (arch, name)
        assert dryrun.model_flops(cfg, shape) == want_flops, (arch, name)

"""Multi-GPU dry run: every (architecture x input shape) on the production
mesh, run as rank 0's program on meta tensors in a fake world, with the
per-GPU roofline terms and memory read off the run.

Counterpart of ``repro/launch/dryrun.py``, with its CLI, its
``effective_config``, ``input_specs``, ``model_flops`` and ``SKIPS``, and
its artifact keys.  The reference lowers and compiles the step for 256 or
512 placeholder devices and reads XLA's cost analysis and HLO; the port
runs one process a rank, so it runs rank 0's shard of the step (every
rank of the SPMD program runs the same shapes):

  * a fake process group of 256 (data 16, model 16) or 512 (pod 2, data
    16, model 16) ranks (``torch.testing._internal.distributed.fake_pg``:
    collectives return at once) and the mesh over it;
  * rank 0's params (``rules.held_specs``), optimizer state, batch shard
    (``rules.batch_spec``) and decode cache (``api.init_cache`` under the
    mesh: ``rules.cache_specs``) as tensors on the meta device: shapes
    without memory;
  * the step of the shape's kind, ``api.make_train_step`` (AdamW, block
    remat), ``make_prefill_step`` or ``make_serve_step`` at the last
    position, under ``mesh_context``; prefill and decode take the flash
    kernels where ``attention.check_flash`` allows (``use_flash``), the
    training step the einsum attention (the kernels have no backward).
    The kernels are custom ops on meta (``kernels/ops.py``): one op each,
    counted as the card runs them;
  * flops: ``torch.utils.flop_counter.FlopCounterMode`` (matrix products
    and the attention kernels' 4 D a (query, key) pair);
  * bytes: every op's tensor inputs and outputs (views and collectives
    excluded), the HBM traffic of an unfused program;
  * collectives: ``sharding/tp.py``'s recorder (every collective of the
    TP path and the data-parallel reductions; ``torch.distributed.nn``'s
    all-to-alls are not booked), as wire bytes with the reference's
    ``_WIRE_FACTOR`` and its ``hlo_ops`` counts of each kind (``fusion``
    is null: there is no HLO);
  * memory: ``argument_bytes`` and ``output_bytes`` of the step, and the
    peak of the bytes of live intermediate tensors (``temp_bytes``; the
    tensors autograd saves held as the graph holds them).

The roofline's denominators are the H100 SXM5 80GB's data sheet at 700 W:
bf16 dense 989e12 FLOP/s, HBM 3.35e12 B/s; a collective's bytes go over
the slowest link its axis crosses, ranks laid out row-major in nodes of 8
GPUs: NVLink 4 (450e9 B/s a direction) inside a node, 400 Gb/s
InfiniBand (50e9 B/s a GPU) across.  A ``model`` axis of 16 spans two
nodes, so it crosses InfiniBand; so do ``data`` and ``pod``.  No constant
of the reference's TPU v5e carries over.

Usage (no GPU needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi_pod]

Artifacts: one JSON per (arch, shape, mesh) under ``artifacts/dryrun_torch/``
(``--out`` to change), keyed as the reference's.  A pair that raises is
printed as a FAIL line and the sweep goes on, as the reference's does.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.configs.registry import ARCHS, SKIPS, long_context_overrides
from repro_torch.models import api
from repro_torch.models.attention import check_flash
from repro_torch.optim.optimizers import adamw, tree_leaves, tree_map
from repro_torch.sharding import rules
from repro_torch.sharding import tp as tp_lib
from repro_torch.sharding.context import Mesh, mesh_context

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")

# H100 SXM5 80GB data sheet (700 W): roofline denominators
PEAK_FLOPS = 989e12          # bf16 dense FLOP/s a GPU
HBM_BW = 3.35e12             # bytes/s a GPU
NVLINK_BW = 450e9            # bytes/s a direction, inside a node
IB_BW = 50e9                 # bytes/s a GPU across nodes (400 Gb/s)
NODE_GPUS = 8
_WIRE_FACTOR = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
LAYOUT = ("ranks row-major over the mesh axes, 8 GPUs a node on NVLink 4 "
          "(450e9 B/s a direction), nodes on 400 Gb/s InfiniBand (50e9 "
          "B/s a GPU); an axis whose span (size x stride) exceeds 8 "
          "crosses InfiniBand")


def effective_config(arch: str, shape: InputShape,
                     remat: str | None = None) -> ArchConfig:
    cfg = ARCHS[arch]
    if shape.name == "long_500k":
        cfg = long_context_overrides(cfg)
    if shape.kind == "train":
        # block remat is the production default for training
        cfg = cfg.with_overrides(remat=remat or "block")
    elif remat:
        cfg = cfg.with_overrides(remat=remat)
    return cfg


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta stand-ins for every model input of the global batch (no
    memory): the train/prefill batch, or the decode cache and token."""
    b, s = shape.global_batch, shape.seq_len
    dt = api.transformer.DTYPES[cfg.dtype]

    def meta(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind in ("train", "prefill"):
        text, batch = s, {}
        if cfg.frontend == "vision":
            text = s - cfg.num_frontend_tokens
            batch["patch_emb"] = meta(b, cfg.num_frontend_tokens,
                                      cfg.d_model, dtype=dt)
        if cfg.frontend == "audio":
            batch["frames"] = meta(b, cfg.encoder_seq, cfg.d_model, dtype=dt)
        batch["tokens"] = meta(b, text)
        if shape.kind == "train":
            batch["sample_weight"] = meta(b, dtype=torch.float32)
        return batch
    return {"caches": api.init_cache(cfg, b, s, device="meta"),
            "tokens": meta(b, 1)}     # under a mesh: the rank's cache


def count_params(cfg: ArchConfig) -> int:
    return sum(x.numel() for x in tree_leaves(api.init_params(cfg)))


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """6 N_active D (train) / 2 N_active D (inference): the useful-FLOPs
    yardstick, as the reference counts it."""
    n_total = count_params(cfg)
    if cfg.is_moe:
        e, k = cfg.num_experts, cfg.top_k
        expert_params = 3 * cfg.d_model * cfg.moe_d_ff
        if cfg.layer_pattern:
            per_unit = sum(1 for i in range(len(cfg.layer_pattern))
                           if cfg.moe_every <= 1 or i % cfg.moe_every == 1)
            n_moe = per_unit * (cfg.num_layers // len(cfg.layer_pattern))
        else:
            n_moe = (cfg.num_layers if cfg.moe_every <= 1
                     else cfg.num_layers // cfg.moe_every)
        n_active = n_total - n_moe * expert_params * (e - k)
    else:
        n_active = n_total
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


# ------------------------------------------------------------ the fake world
def fake_world(shape: tuple, axes: tuple) -> Mesh:
    """A fake process group of prod(shape) ranks, this process rank 0, and
    the mesh over it; one a process (a second call raises)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is "
                               f"up; the dry run needs {n}")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    return Mesh(init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes))


def production_mesh(multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return fake_world((2, 16, 16), ("pod", "data", "model"))
    return fake_world((16, 16), ("data", "model"))


def axis_bandwidth(mesh, axes: tuple) -> float:
    """The link a collective over ``axes`` crosses, ranks row-major in
    nodes of 8: NVLink when every axis's span fits a node, else
    InfiniBand."""
    names = list(mesh.axis_names)
    for a in axes:
        stride = math.prod(mesh.shape[b] for b in names[names.index(a) + 1:])
        if mesh.shape[a] * stride > NODE_GPUS:
            return IB_BW
    return NVLINK_BW


# ----------------------------------------------------------- the counters
_VIEWLESS = ("c10d", "_c10d_functional")


class ByteCounter(TorchDispatchMode):
    """Bytes every op reads and writes (its tensor inputs and outputs;
    views and collectives move none), and the peak of the bytes of live
    tensors the ops made (``base`` bytes of arguments under them)."""

    def __init__(self, base: int = 0) -> None:
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.base = base

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.namespace in _VIEWLESS:
            return out
        moved = 0
        for x in torch.utils._pytree.tree_leaves((args, kwargs)):
            if isinstance(x, torch.Tensor):
                moved += x.numel() * x.element_size()
        for y in torch.utils._pytree.tree_leaves(out):
            if isinstance(y, torch.Tensor):
                n = y.numel() * y.element_size()
                moved += n
                if not func._schema.is_mutable:
                    self.live += n
                    weakref.finalize(y, self._free, n)
        self.bytes += moved
        self.peak = max(self.peak, self.live)
        return out


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size()
               for x in torch.utils._pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _meta_local(cfg: ArchConfig, mesh) -> dict:
    """Rank 0's params on the meta device (``rules.held_specs``)."""
    full = api.init_params(cfg)
    specs = rules.held_specs(cfg, mesh)
    if specs is None:
        return full
    return tree_map(lambda leaf, spec: leaf[rules.shard_index(
        mesh, spec, tuple(leaf.shape), mesh)].clone(), full, specs)


def _local_batch(batch: dict, cfg: ArchConfig, shape: InputShape,
                 mesh) -> dict:
    spec = rules.batch_spec(cfg, shape, mesh)
    return {k: v[rules.shard_index(mesh, spec.get(k, ()), tuple(v.shape),
                                   mesh)] for k, v in batch.items()}


def _flash_ok(cfg: ArchConfig, shape: InputShape, cache_mode: str) -> bool:
    """Whether the step runs the flash kernels: prefill and decode where
    ``attention.check_flash`` allows and, for the encoder-decoder's
    prefill, the queries fit the encoder positions."""
    if shape.kind == "train":
        return False
    try:
        check_flash(cfg.with_overrides(use_flash=True), cache_mode)
    except NotImplementedError:
        return False
    return not (cfg.cross_attention and shape.kind == "prefill"
                and shape.seq_len > cfg.encoder_seq)


def run_step(cfg: ArchConfig, shape: InputShape, mesh,
             cache_mode: str = "full"):
    """Rank 0's step of ``shape``'s kind on meta tensors under the flop,
    byte and collective counters.  Returns (cost dict, recorder,
    memory dict, whether the flash kernels ran)."""
    flash = _flash_ok(cfg, shape, cache_mode)
    cfg = cfg.with_overrides(use_flash=flash)
    params = _meta_local(cfg, mesh)
    with mesh_context(mesh):
        if shape.kind == "train":
            opt = adamw(3e-4)
            state = opt.init(params)
            batch = _local_batch(input_specs(cfg, shape), cfg, shape, mesh)
            args = (params, state, batch)
            step = api.make_train_step(cfg, opt)

            def call():
                return step(params, state, batch, 0)
        elif shape.kind == "prefill":
            batch = _local_batch(input_specs(cfg, shape), cfg, shape, mesh)
            args = (params, batch)
            step = api.make_prefill_step(cfg)

            def call():
                return step(params, batch)
        else:
            s_cache = (api.cache_length(cfg, shape.seq_len)
                       if cache_mode == "ring" else shape.seq_len)
            caches = api.init_cache(cfg, shape.global_batch, s_cache,
                                    device="meta")
            tokens = _local_batch({"tokens": input_specs(cfg, shape)[
                "tokens"]}, cfg, shape, mesh)["tokens"]
            args = (params, caches, tokens)
            step = api.make_serve_step(cfg, cache_mode)

            def call():
                return step(params, caches, tokens, s_cache - 1)
        grad = torch.enable_grad() if shape.kind == "train" \
            else torch.no_grad()
        counter = ByteCounter(_nbytes(args))
        with grad, tp_lib.recording() as rec, \
                FlopCounterMode(display=False) as flops, counter, \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                         lambda t: t):
            out = call()
    memory = {"argument_bytes": _nbytes(args),
              "output_bytes": _nbytes(out),
              "temp_bytes": counter.peak,
              "temp_bytes_bf16_adj": counter.peak}
    cost = {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes)}
    return cost, rec, memory, flash


def collective_seconds(rec, mesh) -> tuple[dict, float]:
    """Wire bytes of each kind (payload x ``_WIRE_FACTOR``) and the
    seconds they take over the links of the axes they ran on (a group the
    mesh did not make: all of its axes)."""
    names = tuple(mesh.axis_names)
    combos = [(a,) for a in names] + [rules.data_axes(mesh), names]
    axes_of = {id(mesh.group(c)): c for c in combos if c}
    wire = {k: int(v * _WIRE_FACTOR[k]) for k, v in rec.bytes.items() if v}
    seconds = sum(n * _WIRE_FACTOR[k] / axis_bandwidth(
        mesh, axes_of.get(gid, names)) for (k, gid), n in rec.by_group.items())
    return wire, seconds


def run_pair(arch: str, shape_name: str, multi_pod: bool = False,
             cache_mode: str = "full", save: bool = True, tag: str = "",
             remat: str | None = None, overrides: dict | None = None,
             mesh=None, out_dir: str | None = None,
             shape: InputShape | None = None) -> dict:
    """One (arch, shape) pair's artifact (saved under ``out_dir``);
    ``overrides`` the config's, ``mesh`` a fake world's mesh (default the
    production one), ``shape`` in place of ``INPUT_SHAPES[shape_name]``."""
    shape = shape or INPUT_SHAPES[shape_name]
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name,
                "skipped": SKIPS[(arch, shape_name)]}
    cfg = effective_config(arch, shape, remat=remat)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    mesh = mesh or production_mesh(multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
                 "cache_mode": cache_mode}
    t0 = time.time()
    cost, coll, memory, flash = run_step(cfg, shape, mesh, cache_mode)
    rec["lower_s"] = round(time.time() - t0, 2)
    rec["compile_s"] = None          # nothing compiled: the run is the count
    rec["use_flash"] = flash
    rec["memory"] = memory
    rec["cost_scanned"] = None       # units are not scanned
    rec["hlo_ops"] = {k: coll.calls[k] for k in tp_lib.KINDS}
    rec["hlo_ops"]["fusion"] = None
    rec["cost"] = cost
    wire, coll_s = collective_seconds(coll, mesh)
    rec["collectives"] = wire
    rec["roofline"] = {
        "compute_s": cost["flops"] / PEAK_FLOPS,
        "memory_s": cost["bytes"] / HBM_BW,
        "collective_s": coll_s,
        "model_flops": model_flops(cfg, shape),
    }
    terms = {k: rec["roofline"][k] for k in
             ("compute_s", "memory_s", "collective_s")}
    rec["roofline"]["bottleneck"] = max(terms, key=terms.get)
    rec["n_chips"] = mesh.size
    rec["params"] = count_params(cfg)
    rec["device"] = {"name": "NVIDIA H100 SXM5 80GB (data sheet, 700 W)",
                     "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                     "nvlink_bw": NVLINK_BW, "ib_bw": IB_BW,
                     "layout": LAYOUT}
    if save:
        out_dir = out_dir or ARTIFACT_DIR
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}_{shape_name}_{rec['mesh']}{tag}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi_pod", action="store_true")
    ap.add_argument("--cache_mode", default="full", choices=["full", "ring"])
    ap.add_argument("--remat", default=None, choices=[None, "none", "block"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default artifacts/dryrun_torch)")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in ARCHS for s in INPUT_SHAPES]
    else:
        shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
        archs = [args.arch] if args.arch else list(ARCHS)
        pairs = [(a, s) for a in archs for s in shapes]

    mesh = production_mesh(args.multi_pod)
    failed = 0
    for arch, shape in pairs:
        try:
            rec = run_pair(arch, shape, multi_pod=args.multi_pod,
                           cache_mode=args.cache_mode, tag=args.tag,
                           remat=args.remat, mesh=mesh, out_dir=args.out)
        except Exception as e:  # keep sweeping; failures are bugs to fix
            failed += 1
            print(f"FAIL  {arch:24s} {shape:12s} {type(e).__name__}: "
                  f"{str(e)[:2000]}")
            continue
        if "skipped" in rec:
            print(f"SKIP  {arch:24s} {shape:12s} {rec['skipped']}")
            continue
        r = rec["roofline"]
        print(f"OK    {arch:24s} {shape:12s} mesh={rec['mesh']} "
              f"run={rec['lower_s']}s "
              f"compute={r['compute_s']:.3e}s memory={r['memory_s']:.3e}s "
              f"coll={r['collective_s']:.3e}s -> {r['bottleneck']}",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Checkpoints in the reference's file formats, so a directory written by
either package is read by the other.

Counterpart of ``repro/train/checkpoint.py``:

  * ``save`` / ``restore`` -- a tree of nested dicts of tensors (the
    trainer's ``{"params", "opt"}``) as ``ckpt_%08d.npz`` with ``/``-joined
    leaf paths, ``latest.json``, and the newest ``max_keep`` kept; restored
    against a template tree, each leaf cast to the template's dtype and
    device.  bfloat16 leaves are stored as float32 (exact both ways; numpy
    has no bfloat16, and the reference's ``restore`` casts to its
    template's dtype).
  * ``save_structured`` / ``restore_structured`` -- a nested
    dict/list/tuple tree of tensors and Python scalars -> .npz of arrays +
    a JSON structure manifest (the sessions' checkpoints, the serve
    cache's spills).  Restored arrays become tensors on the caller's
    device; ``exists_structured`` says whether a directory holds one.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Leaves of nested dicts by their ``/``-joined key paths."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = v
    return flat


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A loaded array as a tensor; the reference's bfloat16 arrays come
    back from ``np.load`` as 2-byte voids and are read bit for bit."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save(directory: str, step: int, tree: Tree, max_keep: int = 3) -> str:
    """``tree`` (nested dicts of tensors) to ``ckpt_{step:08d}.npz`` in
    ``directory``, ``latest.json`` pointing at it; keeps the newest
    ``max_keep`` checkpoints."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    flat = _flatten(tree)
    np.savez(path, **{k: _to_numpy(flat[k]) for k in sorted(flat)})
    with open(os.path.join(directory, "latest.json"), "w") as f:
        json.dump({"step": step, "path": path}, f)
    ckpts = sorted(p for p in os.listdir(directory) if p.startswith("ckpt_"))
    for old in ckpts[:-max_keep]:
        os.remove(os.path.join(directory, old))
    return path


def restore(directory: str, template: Tree,
            step: int | None = None) -> tuple[Tree, int]:
    """The checkpoint of ``step`` (the latest unless given) as a tree shaped
    like ``template``, each leaf in the template leaf's dtype and on its
    device; returns (tree, step).  The checkpoint must hold exactly the
    template's leaf paths."""
    if step is None:
        with open(os.path.join(directory, "latest.json")) as f:
            step = json.load(f)["step"]
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    flat = _flatten(template)
    with np.load(path) as data:
        if set(flat) != set(data.files):
            raise ValueError(f"checkpoint/template mismatch: "
                             f"{sorted(set(flat) ^ set(data.files))}")
        leaves = {k: _from_numpy(data[k]) for k in flat}
    for k, leaf in flat.items():
        if tuple(leaves[k].shape) != tuple(leaf.shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(leaves[k].shape)}"
                             f" != template {tuple(leaf.shape)}")

    def rebuild(node: Tree, prefix: str) -> Tree:
        return {k: rebuild(v, f"{prefix}{k}/") if isinstance(v, dict)
                else leaves[f"{prefix}{k}"].to(device=v.device, dtype=v.dtype)
                for k, v in node.items()}

    return rebuild(template, ""), step


def _encode_structure(tree: Tree, arrays: dict[str, np.ndarray]) -> Any:
    """Encode a nested dict/list/tuple tree into a JSON-able structure spec;
    array leaves are swapped for npz keys, Python scalars inline."""
    if isinstance(tree, dict):
        if not all(isinstance(k, (str, int)) for k in tree):
            raise TypeError(f"save_structured: dict keys must be str/int, "
                            f"got {sorted(map(type, tree), key=repr)}")
        return {"t": "d", "k": list(tree.keys()),
                "c": [_encode_structure(v, arrays) for v in tree.values()]}
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):
            raise TypeError(f"save_structured: namedtuple nodes "
                            f"({type(tree).__name__}) would be restored as "
                            f"plain tuples; convert to dict first")
        return {"t": "t", "c": [_encode_structure(v, arrays) for v in tree]}
    if isinstance(tree, list):
        return {"t": "l", "c": [_encode_structure(v, arrays) for v in tree]}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"t": "p", "v": tree}
    key = f"arr_{len(arrays)}"
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    arrays[key] = np.asarray(tree)
    return {"t": "a", "key": key}


def _decode_structure(spec: Any, arrays, device) -> Tree:
    if spec["t"] == "d":
        return {k: _decode_structure(c, arrays, device)
                for k, c in zip(spec["k"], spec["c"])}
    if spec["t"] == "t":
        return tuple(_decode_structure(c, arrays, device) for c in spec["c"])
    if spec["t"] == "l":
        return [_decode_structure(c, arrays, device) for c in spec["c"]]
    if spec["t"] == "p":
        return spec["v"]
    return torch.from_numpy(np.array(arrays[spec["key"]])).to(device)


def save_structured(directory: str, step: int, tree: Tree,
                    meta: Any = None, max_keep: int = 3) -> str:
    """Template-free checkpoint of a nested tree: arrays go to .npz, the
    container structure (plus optional JSON-able ``meta``) to a sidecar
    manifest.  Keeps the newest ``max_keep`` states."""
    os.makedirs(directory, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    spec = _encode_structure(tree, arrays)
    path = os.path.join(directory, f"state_{step:08d}.npz")
    np.savez(path, **arrays)
    with open(os.path.join(directory, f"state_{step:08d}.json"), "w") as f:
        json.dump({"structure": spec, "meta": meta, "step": step}, f)
    with open(os.path.join(directory, "latest_state.json"), "w") as f:
        json.dump({"step": step, "path": path}, f)
    states = sorted(p for p in os.listdir(directory)
                    if p.startswith("state_") and p.endswith(".npz"))
    for old in states[:-max_keep]:
        os.remove(os.path.join(directory, old))
        sidecar = old[:-len(".npz")] + ".json"
        if os.path.exists(os.path.join(directory, sidecar)):
            os.remove(os.path.join(directory, sidecar))
    return path


def exists_structured(directory: str) -> bool:
    """Whether ``directory`` holds a restorable structured checkpoint (the
    serve cache's test between a spilled session and an unknown one)."""
    return os.path.exists(os.path.join(directory, "latest_state.json"))


def restore_structured(directory: str, step: int | None = None, *,
                       device: str | torch.device) -> tuple[Tree, Any, int]:
    """Inverse of save_structured: returns (tree, meta, step), with every
    array a tensor on ``device``."""
    if step is None:
        with open(os.path.join(directory, "latest_state.json")) as f:
            step = json.load(f)["step"]
    with open(os.path.join(directory, f"state_{step:08d}.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(directory, f"state_{step:08d}.npz")) as arrays:
        tree = _decode_structure(manifest["structure"], arrays, device)
    return tree, manifest["meta"], step

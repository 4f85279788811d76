"""Structured checkpoints: a nested dict/list/tuple tree of tensors and
Python scalars -> .npz of arrays + a JSON structure manifest.

Counterpart of ``repro/train/checkpoint.py``'s ``save_structured`` /
``restore_structured``, in the same file format, so a directory written by
either package is read by the other.  Restored arrays become tensors on the
caller's device.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

Tree = Any


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

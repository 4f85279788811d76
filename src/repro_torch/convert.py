"""Weight carrier: sessions fitted by the JAX package, read into the port.

``state_from_reference`` reads a checkpoint directory written by the
reference's ``SessionState.save`` with numpy alone (an .npz of arrays plus
a JSON manifest, the format both packages share) and returns the port's
``SessionState``, so the port can resume or predict with a session the
reference fitted.  A session checkpointed mid-run with a wire channel comes
with its per-link top-k residuals (``codec_state``) and its budget spend
and DP release counts (``comm``), which ``Protocol.resume_state`` restores
onto the port's transport; a protocol variant's or a scenario's session
with its variant state (``proto``: FedAvg's flat global params ``g``,
Assisted Learning's residual ``R``, the clock-skew history ``w_hist``),
which the resumed session continues from.  ``params_from_numpy`` converts one learner's fitted
params the same way, ``model_params_from_numpy`` a model-zoo parameter
tree (the serve and training paths' weights), ``neural_params_from_numpy``
a classifier's or neural backbone's tree and ``opt_state_from_numpy``
an optimizer state over such a tree (the reference trainer's
``{"params", "opt"}`` checkpoints).  ``local_shards_from_numpy`` cuts one
rank's shard of each leaf of full arrays by the sharding rules' specs
(``repro_torch.sharding.rules``), as a multi-device path takes its
weights.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import SessionState
from repro_torch.device import resolve_device
from repro_torch.learners.base import Learner


def params_from_numpy(learner: Learner, params: Mapping) -> dict:
    """One learner's params as tensors on the learner's device, in the
    dtypes it fits them in (``learner.param_dtypes``)."""
    want = learner.param_dtypes
    if set(params) != set(want):
        raise ValueError(f"{type(learner).__name__} params are {sorted(want)}, "
                         f"got {sorted(params)}")
    return {k: torch.as_tensor(np.asarray(v), dtype=want[k],
                               device=learner.torch_device)
            for k, v in params.items()}


def state_from_reference(directory: str, step: int | None = None, *,
                         device: str | torch.device = "cuda") -> SessionState:
    """The reference checkpoint in ``directory`` (latest step unless
    ``step``) as the port's SessionState on ``device``.  Learner params keep
    the reference's dtypes, which are the port's."""
    state = SessionState.restore(directory, step=step,
                                 device=resolve_device(device))
    if state.key.shape != (2,):
        raise ValueError(f"expected threefry key data of shape (2,), got "
                         f"{state.key.shape}")
    if state.w.dtype != torch.float32 or state.w.dim() != 1:
        raise ValueError(f"expected a float32 ignorance vector, got "
                         f"{state.w.dtype} {tuple(state.w.shape)}")
    return state


def _tensor(a) -> torch.Tensor:
    """A numpy array as a tensor; bfloat16 arrays (the ``ml_dtypes`` type
    JAX hands to numpy) are carried over bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def model_params_from_numpy(cfg: ArchConfig, params: Mapping, *,
                            device: str | torch.device = "cuda") -> dict:
    """The JAX package's model parameter tree (``repro.models.api
    .init_params``, the encoder-decoder's too; leaves as numpy arrays,
    per-layer leaves stacked on axis 0 as its ``scan`` lays them out) as
    the port's parameters on ``device``, each leaf in the dtype the port's
    ``init_params`` gives it: ``cfg.dtype``, but float32 for the SSM's
    ``A_log``, ``D`` and ``dt_bias``, as in the reference.  The tree must
    match the port's for ``cfg`` leaf for leaf, with the same shapes."""
    from repro_torch.models import api
    want = api.init_params(cfg)                  # shapes and dtypes (meta)
    dev = resolve_device(device)

    def walk(w: Mapping, got: Mapping, path: str) -> dict:
        if not isinstance(got, Mapping) or set(got) != set(w):
            keys = sorted(got) if isinstance(got, Mapping) else type(got)
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(w)}, got {keys}")
        out = {}
        for k, v in w.items():
            where = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, got[k], where)
                continue
            t = _tensor(got[k])
            if tuple(t.shape) != tuple(v.shape):
                raise ValueError(f"{where}: expected shape {tuple(v.shape)}, "
                                 f"got {tuple(t.shape)}")
            out[k] = t.to(device=dev, dtype=v.dtype)
        return out

    return walk(want, params, "")


def neural_params_from_numpy(cfg: ArchConfig, params: Mapping, *,
                             device: str | torch.device = "cuda") -> dict:
    """A classifier's or a neural backbone's params (the reference's
    ``models.classifier.init_params`` tree, plus ``proj`` for
    ``learners.neural``) as the port's: the backbone through
    :func:`model_params_from_numpy`, ``cls_head.w`` in ``cfg.dtype`` and
    ``proj`` in float32."""
    from repro_torch.models import transformer
    dev = resolve_device(device)
    extra = {"cls_head", "proj"}
    out = model_params_from_numpy(
        cfg, {k: v for k, v in params.items() if k not in extra},
        device=dev)
    out["cls_head"] = {"w": _tensor(params["cls_head"]["w"]).to(
        device=dev, dtype=transformer.DTYPES[cfg.dtype])}
    if "proj" in params:
        out["proj"] = _tensor(params["proj"]).to(device=dev,
                                                 dtype=torch.float32)
    return out


def opt_state_from_numpy(cfg: ArchConfig, opt_state: Mapping, *,
                         device: str | torch.device = "cuda") -> dict:
    """The reference optimizer's state over a model parameter tree
    (``adamw``: ``{"m", "v"}``; ``sgd``: ``{"mu"}`` or ``{}``) as the
    port's: every entry a tree converted by :func:`model_params_from_numpy`
    (moments are ``zeros_like`` the params: the same tree and leaf
    dtypes)."""
    return {k: model_params_from_numpy(cfg, v, device=device)
            for k, v in opt_state.items()}


def local_shards_from_numpy(tree, specs, mesh, coord=None, *,
                            device: str | torch.device = "cuda"):
    """One rank's shard of each leaf of ``tree`` (full numpy arrays, in
    nested dicts, lists and NamedTuples) under ``specs`` (the same tree
    with the sharding rules' spec tuples as leaves) on ``mesh``: the rank
    at ``coord`` (a dict of axis -> index), or this rank of a
    :class:`~repro_torch.sharding.context.Mesh` when None.  Tensors on
    ``device``, bfloat16 carried bit for bit."""
    from repro_torch.sharding import rules
    dev = resolve_device(device)
    where = mesh if coord is None else coord

    def walk(node, spec):
        if rules.is_spec(spec):
            a = np.asarray(node)
            cut = a[rules.shard_index(mesh, spec, a.shape, where)]
            return _tensor(cut).to(dev)
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(*(walk(v, s) for v, s in zip(node, spec)))
        return type(node)(walk(v, s) for v, s in zip(node, spec))

    return walk(tree, specs)

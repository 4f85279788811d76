"""Resident-session cache: LRU over servable session states, spilling to
checkpoints.

Counterpart of ``repro/serve/cache.py``.  A serve fleet holds many fitted
sessions, ``capacity`` of them resident (their tensors on the device);
the rest are spilled through the structured checkpoint writer
(:func:`repro_torch.train.checkpoint.save_structured`) and restored on
their next touch.  The round trip is exact, so a spilled and restored
session serves what a resident one serves: predictions, booked bits, DP
releases.  Only the arrays spill (:class:`ServeSessionState`); the plan
and the endpoint names stay in the engine's registry.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.compiled import tree_map
from repro_torch.train.checkpoint import (exists_structured,
                                          restore_structured,
                                          save_structured)


@dataclass
class ServeSessionState:
    """The array half of one servable session: what the serve step reads.
    ``params`` / ``alphas`` / ``valid`` are the fitted session's
    (agent-major ``SessionResult`` fields), on its device; ``key_data`` the
    session's key as uint32 words on the host (what its serve draws are
    indexed by); ``rem_session`` / ``rem_link`` the remaining budget
    (int32 on the device, int32 max: uncapped), which serving counts
    down."""
    params: tuple
    alphas: torch.Tensor
    valid: torch.Tensor
    key_data: np.ndarray
    rem_session: torch.Tensor
    rem_link: torch.Tensor

    def tree(self) -> dict:
        return {"params": self.params, "alphas": self.alphas,
                "valid": self.valid, "key_data": self.key_data,
                "rem_session": self.rem_session, "rem_link": self.rem_link}

    @classmethod
    def from_tree(cls, tree: dict, device) -> "ServeSessionState":
        """A restored tree (host tensors): the arrays moved to ``device``,
        the key data kept on the host as uint32 words."""
        def put(x):
            return x.to(device)
        return cls(params=tree_map(put, tree["params"]),
                   alphas=put(tree["alphas"]), valid=put(tree["valid"]),
                   key_data=tree["key_data"].numpy().astype(np.uint32),
                   rem_session=put(tree["rem_session"]),
                   rem_link=put(tree["rem_link"]))


class SessionCache:
    """LRU cache of :class:`ServeSessionState` with disk spill.  ``put``
    admits or refreshes a session, ``get`` returns it resident (restored
    from its spill on a miss, to ``device``), both spilling the least
    recently used past ``capacity``; ``evict`` forces one out.  The events
    (``hits``, ``restores``, ``spills``) are counted in the registry as
    ``cache_events_total{event}``."""

    def __init__(self, capacity: int = 8, spill_dir: str | None = None,
                 registry=None, device="cuda") -> None:
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.device = torch.device(device)
        self._own_dir = spill_dir is None
        self.spill_dir = (tempfile.mkdtemp(prefix="repro_torch_spill_")
                          if spill_dir is None else spill_dir)
        os.makedirs(self.spill_dir, exist_ok=True)
        self._resident: OrderedDict[str, ServeSessionState] = OrderedDict()
        if registry is None:
            from repro_torch.telemetry.registry import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry

    def _event(self, event: str) -> None:
        self.registry.inc("cache_events_total", 1, event=event)

    @property
    def hits(self) -> int:
        return self.registry.value("cache_events_total", event="hit")

    @property
    def restores(self) -> int:
        return self.registry.value("cache_events_total", event="restore")

    @property
    def spills(self) -> int:
        return self.registry.value("cache_events_total", event="spill")

    def _dir(self, session_id: str) -> str:
        return os.path.join(self.spill_dir, str(session_id))

    def _spill(self, session_id: str, state: ServeSessionState) -> None:
        save_structured(self._dir(session_id), 0, state.tree(), max_keep=1)
        self._event("spill")

    def _spill_lru(self) -> None:
        while len(self._resident) > self.capacity:
            self._spill(*self._resident.popitem(last=False))

    def __contains__(self, session_id: str) -> bool:
        return (session_id in self._resident
                or exists_structured(self._dir(session_id)))

    def __len__(self) -> int:
        return len(self._resident)

    @property
    def resident_ids(self) -> tuple:
        return tuple(self._resident)

    def put(self, session_id: str, state: ServeSessionState) -> None:
        self._resident[session_id] = state
        self._resident.move_to_end(session_id)
        self._spill_lru()

    def get(self, session_id: str) -> ServeSessionState:
        if session_id in self._resident:
            self._resident.move_to_end(session_id)
            self._event("hit")
            return self._resident[session_id]
        if not exists_structured(self._dir(session_id)):
            raise KeyError(f"unknown session {session_id!r} (never put, "
                           f"or its spill directory is gone)")
        tree, _, _ = restore_structured(self._dir(session_id), device="cpu")
        state = ServeSessionState.from_tree(tree, self.device)
        self._event("restore")
        self.put(session_id, state)
        return state

    def evict(self, session_id: str) -> None:
        """Force one session out to disk."""
        if session_id in self._resident:
            self._spill(session_id, self._resident.pop(session_id))

    def stats(self) -> dict:
        return {"capacity": self.capacity, "resident": len(self._resident),
                "hits": self.hits, "restores": self.restores,
                "spills": self.spills}

    def close(self) -> None:
        """Remove the spill directory, if this cache made it."""
        if self._own_dir:
            shutil.rmtree(self.spill_dir, ignore_errors=True)

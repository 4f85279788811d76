"""Continuous batching for score-block prediction traffic.

Counterpart of ``repro/serve/batcher.py``.  Requests against resident
sessions queue up, and ``flush`` drains the queue as a few bucketed serve
programs instead of one program a request.  A bucket is keyed by the
SessionPlan and the agents' feature-block shapes, so every slot of a
bucket runs the program :func:`repro_torch.core.compiled.serve_batch`
lowers for that shape; a bucket is padded to the next power of two
(at most ``max_batch``) with copies of a slot whose ``deliver`` mask is
all False, which ship nothing and book nothing.

The vmap never mixes slots, so a batched slot is what the same request
served alone gives.  One ordering rule keeps that true for sequences of
requests: a flush drains the queue in waves of at most one request a
session, because two budgeted requests against one session must see each
other's spend, and two slots of one call cannot.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.core import compiled
from repro_torch.telemetry.spans import fence_of, span_of


@dataclass
class Slot:
    """One admitted request, ready for its bucket: the plan, the session's
    key data and the request tag its draws are indexed by (and the draw
    ``source``, None: the default), the agents' feature blocks and the
    admission ``deliver`` mask.  The session's arrays are resolved when
    the slot runs (``Batcher.resolve``), not captured here: budget
    counters move between waves."""
    request_id: int
    session_id: str
    tenant: str
    plan: Any
    key: Any
    Xs: tuple
    deliver: Any
    decision: Any = None
    state: Any = None               # used when no resolver is set
    request: Any = None
    source: Any = None

    @property
    def bucket(self) -> tuple:
        return (self.plan, tuple(tuple(x.shape) for x in self.Xs))


@dataclass
class Batcher:
    """Collects :class:`Slot` s and runs them as bucketed batched serve
    programs.  ``flush`` returns ``[(slot, ServeResult)]`` in request
    order, each result the slot's slice on the host (numpy, no leading
    axis).  ``resolve`` maps a slot to its session's live state (the
    engine plugs its cache in); ``settle`` is called for each slot of a
    wave before the next wave runs.  ``batches_run`` / ``slots_run`` /
    ``padded_slots`` count in the registry as ``batch_events_total
    {event}``.  ``tracer`` (a :class:`~repro_torch.telemetry.spans.
    SpanTracer`) opens a ``flush_wave`` span a wave and a fenced
    ``bucket_dispatch`` span a bucket program; ``live`` makes the bucket
    programs tap each request (the pad slots' taps are dropped by the
    sink)."""
    max_batch: int = 8
    resolve: Any = None
    pending: list = field(default_factory=list)
    registry: Any = None
    tracer: Any = None
    live: bool = False

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.registry is None:
            from repro_torch.telemetry.registry import MetricsRegistry
            self.registry = MetricsRegistry()

    @property
    def batches_run(self) -> int:
        return self.registry.value("batch_events_total", event="batch")

    @property
    def slots_run(self) -> int:
        return self.registry.value("batch_events_total", event="slot")

    @property
    def padded_slots(self) -> int:
        return self.registry.value("batch_events_total", event="pad")

    def add(self, slot: Slot) -> None:
        self.pending.append(slot)

    def __len__(self) -> int:
        return len(self.pending)

    def _pad_to(self, b: int) -> int:
        size = 1
        while size < b:
            size *= 2
        return min(size, self.max_batch)

    def _waves(self) -> list:
        """The queue in waves of at most one slot a session, in request
        order."""
        waves, rest = [], self.pending
        while rest:
            seen, wave, deferred = set(), [], []
            for slot in rest:
                if slot.session_id in seen:
                    deferred.append(slot)
                else:
                    seen.add(slot.session_id)
                    wave.append(slot)
            waves.append(wave)
            rest = deferred
        return waves

    def _state(self, slot: Slot):
        return self.resolve(slot) if self.resolve is not None else slot.state

    def _run_chunk(self, chunk: list) -> list:
        plan = chunk[0].plan
        pad = self._pad_to(len(chunk)) - len(chunk)
        args = [{"key": s.key, "request": s.request, "source": s.source,
                 "Xs": s.Xs, "params": st.params, "alphas": st.alphas,
                 "valid": st.valid, "rem_session": st.rem_session,
                 "rem_link": st.rem_link, "deliver": s.deliver}
                for s, st in ((s, self._state(s)) for s in chunk)]
        if pad:
            filler = dict(args[0], deliver=np.zeros_like(
                np.asarray(args[0]["deliver"])))
            args.extend([filler] * pad)
        # the fence: the span times the computation, not the queued launches
        with span_of(self.tracer, "bucket_dispatch", slots=len(chunk),
                     pad=pad):
            res = fence_of(self.tracer,
                           compiled.serve_batch(plan, args, live=self.live))
        self.registry.inc("batch_events_total", 1, event="batch")
        self.registry.inc("batch_events_total", len(chunk), event="slot")
        if pad:
            self.registry.inc("batch_events_total", pad, event="pad")
        # one copy to the host a field for the whole batch; the slots'
        # slices are then numpy views
        preds, blocks, sent, codec_idx, exhausted = (
            f.cpu().numpy() for f in res)
        return [(slot, compiled.ServeResult(
                    preds=preds[i], blocks=blocks[i], sent=sent[i],
                    codec_idx=codec_idx[i], exhausted=exhausted[i]))
                for i, slot in enumerate(chunk)]

    def flush(self, settle=None) -> list:
        out = []
        waves = self._waves()
        self.pending = []
        for w, wave in enumerate(waves):
            with span_of(self.tracer, "flush_wave", step=w,
                         slots=len(wave)):
                buckets: dict = {}
                for slot in wave:
                    buckets.setdefault(slot.bucket, []).append(slot)
                wave_out = []
                for group in buckets.values():
                    for lo in range(0, len(group), self.max_batch):
                        wave_out.extend(
                            self._run_chunk(group[lo:lo + self.max_batch]))
                wave_out.sort(key=lambda pair: pair[0].request_id)
                if settle is not None:
                    # before the next wave: a later request against the
                    # same session starts from the counters after this
                    # one's spend
                    for slot, res in wave_out:
                        settle(slot, res)
                out.extend(wave_out)
        out.sort(key=lambda pair: pair[0].request_id)
        return out

    def stats(self) -> dict:
        return {"batches_run": self.batches_run,
                "slots_run": self.slots_run,
                "padded_slots": self.padded_slots,
                "max_batch": self.max_batch}

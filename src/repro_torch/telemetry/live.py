"""In-flight metric emission from compiled programs (and their eager twins).

Counterpart of ``repro/telemetry/live.py``.  The compiled backend books
its metrics after the run, when ``Protocol._replay_traffic`` walks the
program's result, so a long ``fleet_run`` is dark while it executes.  The
live plane adds taps inside the program: each round of a session (and
each served request) stages a small int32 vector of what the round body
already computed, and a host-side :class:`LiveSink` folds it into the
registry's ``live_*`` series, the streaming JSONL trace and the
dashboard while the program runs.  The taps are in every compiled
program the port has: a session's rounds (``compiled_session``, the async
barrier's ``async_session``, priced as the async replay books a round:
its alphas and its release or raw scores), a fleet's and a control
sweep's (one tap a session or config and round, ``fleet_run`` and
``control_sweep_run``: the vmap rule below stages a round's taps as one
copy) and a served request's (``serve_session``, ``serve_batch``).

Delivery reads nothing back inside the program.  A tap on the card copies
its vector (``non_blocking``) into pinned host memory and records a CUDA
event; the host delivers every tap whose event has completed at the next
tap site, and when :func:`installed` exits it waits on the last event
(the counterpart of ``jax.effects_barrier``).  A tap on the CPU delivers
at once.  Under ``torch.func.vmap`` (``fleet_run``, ``serve_batch``) the
tap is a ``torch.library`` custom op whose vmap rule stages the whole
``[F, width]`` block as one copy; an unbatched payload is replicated
``batch_size`` times, so that every session delivers its own tap (the
reference's ``key_salt``).  The op takes a ``salt``, a tensor the batch
axis reaches (a draw of the session, a feature block of the request), so
that the rule runs even when every payload value is the same across the
batch.

The contract (tests/test_torch_telemetry_live.py, chip_smoke phase 17):

  * live on == live off bit for bit: the taps read values, nothing flows
    back into the program;
  * at exit the ``live_*`` series equal the replay-booked ones: the
    program prices a round's bits with the replay's formulas
    (``live_wire_bits_total == wire_bits_total``, the ignorance and
    score-block messages, the budget skips);
  * eager == compiled: the eager engine calls the sink directly with the
    same payloads, and every sink update is commutative (sums and a max),
    so the order in which taps arrive does not matter.

Gating is on the host: compiled taps fire for every round (after an
early stop too) and every slot of a padded bucket, with an ``active``
flag the sink drops them by.  Wall-clock time appears only in the live
trace events and the dashboard, never in the registry.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager

import torch

#: The sink compiled taps go to, set by :func:`installed` around a
#: dispatch (the program's taps reach whatever sink the current run
#: installed).
_SINK: "LiveSink | None" = None

_TRANSFORMS_ACTIVE = getattr(torch._C, "_are_functorch_transforms_active",
                             None)


@contextmanager
def installed(sink: "LiveSink | None"):
    """Route compiled taps to ``sink`` for the ``with`` block (a no-op for
    None).  On exit every staged tap is delivered, waiting on the last
    one's event, before the previous sink is restored."""
    global _SINK
    if sink is None:
        yield
        return
    prev = _SINK
    _SINK = sink
    try:
        yield
    finally:
        sink.drain(wait=True)
        _SINK = prev


def _stage(tag: str, packed: torch.Tensor) -> None:
    """Hand a tap's payload ([width] or [F, width] int32) to the installed
    sink, if any."""
    if _SINK is not None:
        _SINK.stage(tag, packed)


@torch.library.custom_op("repro_torch::live_tap", mutates_args=())
def _tap_op(packed: torch.Tensor, salt: torch.Tensor, tag: str) -> None:
    _stage(tag, packed)


@_tap_op.register_fake
def _(packed, salt, tag):
    return None


@_tap_op.register_vmap
def _(info, in_dims, packed, salt, tag):
    if in_dims[0] is None:
        packed = packed.expand(info.batch_size, *packed.shape)
    else:
        packed = packed.movedim(in_dims[0], 0)
    _stage(tag, packed)
    return None, None


# ---------------------------------------------------- program-side helpers
def _pack(salt: torch.Tensor, *vals) -> torch.Tensor:
    """One int32 vector a tap (one copy instead of one a scalar); ints
    become tensors on ``salt``'s device."""
    return torch.stack([
        v.to(torch.int32) if isinstance(v, torch.Tensor)
        else torch.full((), int(v), dtype=torch.int32, device=salt.device)
        for v in vals])


def _tap(tag: str, packed: torch.Tensor, salt: torch.Tensor) -> None:
    if _TRANSFORMS_ACTIVE is None or _TRANSFORMS_ACTIVE():
        _tap_op(packed, salt, tag)
    else:
        _stage(tag, packed)


def emit_round(salt, t, active, bits, sent, skipped, new_exh) -> None:
    """Stage a round tap inside a program: the round index, whether it ran
    (False after the stop; the sink drops it), its priced bits, the hops
    sent and skipped, and whether the budget ran dry in it.  ``salt``: a
    tensor the fleet's batch axis reaches."""
    _tap("round", _pack(salt, t, active, bits, sent, skipped, new_exh), salt)


def emit_serve(salt, active, bits, sent, skipped) -> None:
    """Stage a serve tap inside a program: one a request (``active`` False
    for a bucket's pad slots), its priced bits, blocks sent and skipped."""
    _tap("serve", _pack(salt, active, bits, sent, skipped), salt)


class LiveSink:
    """The host end of the taps: folds each tap into the registry's
    ``live_*`` series, streams a ``{"type": "live", ...}`` event to the
    open trace (``writer``) and calls the dashboard's hook
    (``on_event``).  Every update is commutative (counter sums, a running
    max for the round gauge), so unordered, eager and batched delivery
    all reach the same registry.  ``copies`` counts the payloads the
    programs staged (on the card one device-to-host copy each)."""

    def __init__(self, registry, writer=None, on_event=None) -> None:
        self.registry = registry
        self.writer = writer
        self.on_event = on_event
        self.taps = 0
        self.copies = 0
        self._max_round = -1
        self._t0: float | None = None
        self._last_t: float | None = None
        # taps copied from the card and not delivered yet: (pinned host
        # copy, its CUDA event, tag), in stream order
        self._pending: deque = deque()

    # ----------------------------------------------------------- delivery
    def stage(self, tag: str, packed: torch.Tensor) -> None:
        """Take a tap's payload: on the card a ``non_blocking`` copy into
        pinned memory and an event (no host read), delivered once the
        event completes; on the CPU at once."""
        self.copies += 1
        if packed.device.type != "cuda":
            self._deliver(tag, packed)
            return
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._pending.append((host, event, tag))
        self.drain()

    def drain(self, wait: bool = False) -> None:
        """Deliver the staged taps whose copy has landed, in stream order;
        with ``wait``, all of them."""
        while self._pending:
            host, event, tag = self._pending[0]
            if wait:
                event.synchronize()
            elif not event.query():
                return
            self._pending.popleft()
            self._deliver(tag, host)

    def _deliver(self, tag: str, values: torch.Tensor) -> None:
        for row in values.reshape(-1, values.shape[-1]).tolist():
            if tag == "round":
                t, active, bits, sent, skipped, new_exh = row
                if active:
                    self.round_tap(t, bits, sent, skipped, new_exh)
            else:
                active, bits, sent, skipped = row
                if active:
                    self.serve_tap(bits, sent, skipped)

    # --------------------------------------------------------------- taps
    def round_tap(self, t: int, bits: int, sent: int, skipped: int,
                  new_exh: int) -> None:
        reg = self.registry
        reg.inc("live_rounds_total", 1)
        reg.inc("live_wire_bits_total", bits)
        reg.inc("live_messages_total", sent, kind="ignorance")
        reg.inc("live_budget_skips_total", skipped)
        reg.inc("live_exhausted_total", new_exh)
        self._max_round = max(self._max_round, t)
        reg.set_gauge("live_round", self._max_round)
        self._stamp({"type": "live", "tag": "round", "t": t, "bits": bits,
                     "sent": sent, "skipped": skipped,
                     "exhausted": new_exh})

    def serve_tap(self, bits: int, sent: int, skipped: int) -> None:
        reg = self.registry
        reg.inc("live_serve_requests_total", 1)
        reg.inc("live_wire_bits_total", bits)
        reg.inc("live_messages_total", sent, kind="score_block")
        reg.inc("live_budget_skips_total", skipped)
        self._stamp({"type": "live", "tag": "serve", "bits": bits,
                     "sent": sent, "skipped": skipped})

    def _stamp(self, event: dict) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self._last_t = now
        self.taps += 1
        event["t_s"] = round(now - self._t0, 6)
        if self.writer is not None:
            self.writer.write_event(event)
        if self.on_event is not None:
            self.on_event(event)

    # -------------------------------------------------------------- reads
    def rate(self) -> float:
        """Taps a second over the sink's life (0.0 before the second)."""
        if self.taps < 2 or self._last_t is None or self._t0 is None:
            return 0.0
        elapsed = self._last_t - self._t0
        return (self.taps - 1) / elapsed if elapsed > 0 else 0.0

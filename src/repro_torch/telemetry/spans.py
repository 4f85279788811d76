"""Span tracing for protocol runs: session -> round -> hop on the train
path, flush -> flush_wave -> bucket_dispatch on the serve path.

Counterpart of ``repro/telemetry/spans.py``.  A :class:`Span` is a closed
wall-clock interval with a name, a parent and JSON-able attributes; the
:class:`SpanTracer` keeps the stack of open spans (nesting follows the
``with`` blocks), records every span, and feeds each closed span's
duration into the registry as a ``span_seconds{name}`` histogram.

:meth:`SpanTracer.fence` waits for the CUDA stream of each device that
holds a tensor of the value a dispatch boundary produced, so that the
span around it measures the computation, not the queueing of its
launches.  Callers fence at dispatch boundaries only (the compiled
session and serve calls, a serve bucket); nothing inside a program
fences.  Tensors on the CPU need no wait.  With ``profile`` each span
also opens a ``torch.profiler.record_function`` range of its name
(``name#step`` when it has a step), so that a trace taken with
``torch.profiler.profile`` lines up with the protocol's rounds and the
serve engine's flush waves.  Neither touches a value.
"""
from __future__ import annotations

import time
from contextlib import ExitStack, contextmanager, nullcontext


class Span:
    """One closed (or still open) traced interval."""

    __slots__ = ("span_id", "parent_id", "name", "start_s", "end_s", "attrs")

    def __init__(self, span_id: int, parent_id: int | None, name: str,
                 start_s: float, attrs: dict) -> None:
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start_s = start_s
        self.end_s: float | None = None
        self.attrs = attrs

    @property
    def duration_s(self) -> float | None:
        return None if self.end_s is None else self.end_s - self.start_s

    def to_event(self) -> dict:
        return {"type": "span", "id": self.span_id,
                "parent": self.parent_id, "name": self.name,
                "start_s": self.start_s, "end_s": self.end_s,
                "attrs": self.attrs}


def tensor_leaves(value):
    """The tensor leaves of nested tuples, lists, dicts and named tuples,
    in order."""
    import torch
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from tensor_leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from tensor_leaves(v)


class SpanTracer:
    """Open and close spans with automatic parenting; record them all.
    ``registry`` (optional) receives a ``span_seconds{name}`` observation
    a closed span; ``clock`` can be replaced in tests; ``on_close`` (the
    streaming trace writer's hook) is called with each span as it
    closes."""

    def __init__(self, registry=None, *, profile: bool = False,
                 clock=time.perf_counter) -> None:
        self.registry = registry
        self.profile = profile
        self.clock = clock
        self.spans: list[Span] = []
        self._stack: list[Span] = []
        self._next_id = 0
        self.on_close = None

    @property
    def current(self) -> Span | None:
        return self._stack[-1] if self._stack else None

    @contextmanager
    def span(self, name: str, step: int | None = None, **attrs):
        """Open a child of the current span for the ``with`` body."""
        parent = self._stack[-1].span_id if self._stack else None
        if step is not None:
            attrs = dict(attrs, step=int(step))
        sp = Span(self._next_id, parent, name, self.clock(), attrs)
        self._next_id += 1
        self.spans.append(sp)
        self._stack.append(sp)
        try:
            with ExitStack() as es:
                if self.profile:
                    import torch.profiler
                    es.enter_context(torch.profiler.record_function(
                        name if step is None else f"{name}#{int(step)}"))
                yield sp
        finally:
            sp.end_s = self.clock()
            self._stack.pop()
            if self.registry is not None:
                self.registry.observe("span_seconds", sp.duration_s,
                                      name=name)
            if self.on_close is not None:
                self.on_close(sp)

    def fence(self, value):
        """Wait for the current CUDA stream of every device that holds a
        tensor of ``value``, then return ``value`` unchanged."""
        if value is not None:
            import torch
            devices = {t.device for t in tensor_leaves(value)
                       if t.device.type == "cuda"}
            for dev in sorted(devices, key=str):
                torch.cuda.current_stream(dev).synchronize()
        return value

    # ------------------------------------------------------------- readback
    def to_events(self) -> list[dict]:
        return [sp.to_event() for sp in self.spans]

    def well_formed(self) -> bool:
        """Every span closed, every parent id known and opened no later
        than its child, no span left open."""
        by_id = {sp.span_id: sp for sp in self.spans}
        for sp in self.spans:
            if sp.end_s is None:
                return False
            if sp.parent_id is not None:
                parent = by_id.get(sp.parent_id)
                if parent is None or parent.start_s > sp.start_s:
                    return False
        return not self._stack


def span_of(owner, name: str, step: int | None = None, **attrs):
    """``owner.span(name, step, **attrs)`` (a :class:`SpanTracer` or a
    ``Telemetry``), or a no-op context when ``owner`` is None."""
    return (nullcontext() if owner is None
            else owner.span(name, step, **attrs))


def fence_of(owner, value):
    """``owner.fence(value)``, or ``value`` untouched when ``owner`` is
    None (a run without telemetry adds no synchronization)."""
    return value if owner is None else owner.fence(value)

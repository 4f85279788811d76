"""Bit ledger for the metered transport (paper Fig. 4).

Counterpart of ``repro/core/transport.py`` (its eager subset): ASCII
transmits per hop the length-n ignorance score plus one scalar model
weight, and once at setup the numeric labels and sample IDs; under a wire
codec the score is booked at its encoded size.  Every booking
passes through :meth:`TransportLog.send_bits`, which appends the entry and
updates the (kind, src, dst) accumulator the aggregate views derive from.
With a telemetry ``registry`` attached (:mod:`repro_torch.telemetry`), the
same booking emits ``wire_bits_total{kind,src,dst}`` and
``messages_total{kind}``: one emission point for both backends, since the
compiled backend books its replayed ledger through this method.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class TransportLog:
    entries: list = field(default_factory=list)
    #: optional telemetry MetricsRegistry, attached by Telemetry
    registry: object = None

    def __post_init__(self):
        self._total = 0
        self._by: dict = {}            # (kind, src, dst) -> bits
        for e in self.entries:
            self._accumulate(e["src"], e["dst"], e["kind"], e["bits"])

    def _accumulate(self, src: str, dst: str, kind: str, bits: int) -> None:
        self._total += bits
        key = (kind, src, dst)
        self._by[key] = self._by.get(key, 0) + bits

    def send(self, src: str, dst: str, kind: str, num_elements: int,
             bits_per_element: int = 32) -> None:
        if isinstance(num_elements, bool) or not isinstance(
                num_elements, (int, np.integer)):
            raise TypeError(f"num_elements must be an integer, got "
                            f"{type(num_elements).__name__} ({num_elements!r})")
        if num_elements < 0:
            raise ValueError(f"num_elements must be >= 0, got {num_elements}")
        self.send_bits(src, dst, kind, int(num_elements) * bits_per_element)

    def send_bits(self, src: str, dst: str, kind: str, bits: int,
                  rung: int | None = None) -> None:
        """Book an exact size in bits (a codec's wire format is not a clean
        elements x width).  ``rung`` records the budget ladder rung that
        priced the payload; entries without one carry no ``rung`` key."""
        if isinstance(bits, bool) or not isinstance(bits, (int, np.integer)):
            raise TypeError(f"bits must be an integer, got "
                            f"{type(bits).__name__} ({bits!r})")
        if bits < 0:
            raise ValueError(f"bits must be >= 0, got {bits}")
        bits = int(bits)
        entry = {"src": src, "dst": dst, "kind": kind, "bits": bits}
        if rung is not None:
            entry["rung"] = int(rung)
        self.entries.append(entry)
        self._accumulate(src, dst, kind, bits)
        if self.registry is not None:
            self.registry.inc("wire_bits_total", bits,
                              kind=kind, src=src, dst=dst)
            self.registry.inc("messages_total", 1, kind=kind)

    @property
    def total_bits(self) -> int:
        return self._total

    def bits_by_kind(self) -> dict:
        """Per-kind totals, name-ordered."""
        out: dict = {}
        for (kind, _src, _dst), bits in self._by.items():
            out[kind] = out.get(kind, 0) + bits
        return dict(sorted(out.items()))

    def bits_by_src(self, kinds=None) -> dict:
        """Per-sender totals (name-ordered), optionally of the given
        message kinds only: what the budget-aware scheduler orders by."""
        out: dict = {}
        for (kind, src, _dst), bits in self._by.items():
            if kinds is not None and kind not in kinds:
                continue
            out[src] = out.get(src, 0) + bits
        return dict(sorted(out.items()))


def oracle_bits(n: int, p_remote: int, bits_per_element: int = 32) -> int:
    """Cost of the oracle: shipping the remote agents' raw features."""
    return n * p_remote * bits_per_element


def oracle_bits_codec(n: int, p_remote: int, codec) -> int:
    """The oracle under a wire codec: the remote [n, p] raw features
    shipped through the same codec the protocol uses."""
    return int(codec.wire_bits((n, p_remote)))

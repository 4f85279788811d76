"""Wire codecs: what an ignorance vector or a score block becomes on the way
to another agent.

Counterpart of ``repro/comm/codecs.py``.  A :class:`Codec` is an
``encode``/``decode`` pair over float32 tensors: length-n ignorance vectors
(training hops) and [n, K] score blocks (prediction-time traffic) alike.
``encode`` gives the wire representation, which :meth:`Codec.wire_bits`
prices; ``decode`` reconstructs what the receiver sees; ``roundtrip`` is
their composition, the channel: the protocol continues from the decoded
tensor, so a lossy codec really degrades the interchange.

  ===========  =======================  ============================
  name         wire format              bits for a length-n vector
  ===========  =======================  ============================
  ``fp32``     raw float32              32n
  ``fp16``     IEEE float16             16n
  ``int8``     int8 + fp32 tile scales  8n + 32·(n / tile_for(n))
  ``int4``     packed int4 (two         8·ceil(n/2) + 32·(n / tile_for(n))
               nibbles per wire byte)
               + fp32 tile scales
  ``topk``     top-k values + indices   k·(32 + ceil(log2 n))
  ===========  =======================  ============================

The int codecs run the quantize kernels (``kernels/quantize.py``:
``roundtrip`` and int8's ``encode`` the quantize-dequant kernel, int4's
``encode`` the quantize with the pack fused into it, int4's ``decode`` the
unpack fused with the dequantize).  ``topk`` keeps a
per-link error-feedback residual, carried in ``SessionState.codec_state``.

Random draws are arguments: a stochastic codec takes the hop's
:class:`~repro_torch.comm.draws.HopDraws` and asks it for its uniforms.
The reference's ``jitted_channel`` has no counterpart: PyTorch runs
eagerly, and both of the port's paths run the same ops.
"""
from __future__ import annotations

import abc
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.quantize import DEFAULT_BN, rows_for, tile_for

SCALE_BITS = 32             # one fp32 scale per quantization tile


def numel(shape) -> int:
    """Element count of a wire payload shape: an int n (a length-n vector)
    or a shape tuple (an [n, K] score block)."""
    if isinstance(shape, (tuple, list, torch.Size)):
        out = 1
        for s in shape:
            out *= int(s)
        return out
    return int(shape)


@dataclass(frozen=True)
class Codec(abc.ABC):
    """An encode/decode pair over float32 tensors of any payload shape."""

    #: Codecs with per-link state (error-feedback residuals) return it from
    #: ``init_state``; stateless codecs leave this False and pass None.
    stateful = False

    @abc.abstractmethod
    def wire_bits(self, shape) -> int:
        """Encoded size in bits of a payload of ``shape`` (an int n or a
        shape tuple like (n, K))."""

    def init_state(self, shape, device=None):
        """Fresh per-link codec state (None for stateless codecs)."""
        return None

    @abc.abstractmethod
    def encode(self, x: torch.Tensor, draws=None, state=None):
        """x -> (wire tuple, new_state)."""

    @abc.abstractmethod
    def decode(self, wire) -> torch.Tensor:
        """wire -> the reconstructed x the receiver sees."""

    def roundtrip(self, x: torch.Tensor, draws=None, state=None):
        """decode(encode(x)); a subclass may fuse the two but must stay
        equal to the pair."""
        wire, state = self.encode(x, draws, state)
        return self.decode(wire), state


@dataclass(frozen=True)
class Fp32Codec(Codec):
    """Passthrough: 32 bits per element."""

    def wire_bits(self, shape) -> int:
        return 32 * numel(shape)

    def encode(self, x, draws=None, state=None):
        return x.to(torch.float32), state

    def decode(self, wire):
        return wire


@dataclass(frozen=True)
class Fp16Codec(Codec):
    """IEEE half precision (round to nearest even)."""

    def wire_bits(self, shape) -> int:
        return 16 * numel(shape)

    def encode(self, x, draws=None, state=None):
        return x.to(torch.float16), state

    def decode(self, wire):
        return wire.to(torch.float32)


@dataclass(frozen=True)
class QuantCodec(Codec):
    """Symmetric int quantization with per-tile fp32 scales.

    ``bits`` per element (8 or 4; int4 travels packed two to a byte).
    ``stochastic`` selects unbiased stochastic rounding (needs the hop's
    draws) against round-half-up.  ``roundtrip`` runs the quantize-dequant
    kernel, and so does int8's ``encode``; int4's ``encode`` and ``decode``
    run the fused int4 wire kernels.  ``decode(encode(x))`` equals
    ``roundtrip(x)``.
    """
    bits: int = 8
    stochastic: bool = True
    bn: int = DEFAULT_BN

    @property
    def qmax(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    def _tile(self, shape) -> int:
        """Elements that share a scale: a block's row tile times its
        width, else the tile of the flat payload."""
        if isinstance(shape, (tuple, list, torch.Size)) and len(shape) == 2:
            n, k = int(shape[0]), int(shape[1])
            return rows_for(n, k, self.bn) * k
        return tile_for(numel(shape), self.bn)

    def _tiles(self, shape) -> int:
        return numel(shape) // self._tile(shape)

    def wire_bits(self, shape) -> int:
        m = numel(shape)
        if self.bits == 4:
            payload = 8 * ((m + 1) // 2)       # whole wire bytes
        else:
            payload = self.bits * m
        return payload + SCALE_BITS * self._tiles(shape)

    def _u(self, x: torch.Tensor, draws) -> torch.Tensor:
        if self.stochastic:
            if draws is None:
                raise ValueError("stochastic QuantCodec needs the hop's draws")
            return draws.uniform(tuple(x.shape), x.device)
        return torch.full(tuple(x.shape), 0.5, dtype=torch.float32,
                          device=x.device)

    def _quantize(self, x, draws, qmax=None):
        qd = ops.quantize_dequant_block if x.dim() == 2 \
            else ops.quantize_dequant
        return qd(x.to(torch.float32).contiguous(), self._u(x, draws),
                  self.qmax if qmax is None else qmax, bn=self.bn)

    def roundtrip(self, x, draws=None, state=None, qmax=None):
        """The quantize-dequant; ``qmax`` overrides the static range with
        a 0-d float32 tensor (a quantization sweep's, batched under vmap:
        ``core.compiled.quant_sweep_run``)."""
        xhat, _, _ = self._quantize(x, draws, qmax)
        return xhat, state

    def encode(self, x, draws=None, state=None):
        if self.bits == 4:
            if x.dim() not in (1, 2):
                raise ValueError(f"QuantCodec takes a vector or an [n, K] "
                                 f"block, got shape {tuple(x.shape)}")
            packed, scales = ops.quantize_pack_int4(
                x.to(torch.float32).contiguous(), self._u(x, draws),
                self.qmax, self._tile(tuple(x.shape)))
            # the shape rides the wire so decode can unpack odd counts
            return (packed, scales, tuple(x.shape)), state
        _, q, scales = self._quantize(x, draws)
        return (q, scales), state

    def decode(self, wire):
        if self.bits == 4:
            packed, scales, shape = wire
            n = numel(shape)
            return ops.unpack_dequant_int4(packed, scales, n,
                                           n // scales.shape[0]
                                           ).reshape(shape)
        q, scales = wire
        if q.dim() == 2:
            n, k = q.shape
            br = n // scales.shape[0]
            return (q.to(torch.float32).reshape(-1, br, k)
                    * scales[:, None, None]).reshape(n, k)
        n = q.shape[0]
        bn = n // scales.shape[0]
        return (q.to(torch.float32).reshape(-1, bn)
                * scales[:, None]).reshape(n)


@dataclass(frozen=True)
class TopKCodec(Codec):
    """Top-k sparsification with per-link error feedback.

    Ships the k = ceil(fraction·m) largest-magnitude entries of x + residual
    as (value, index) pairs; what decode cannot reconstruct becomes the new
    residual, re-offered on the link's next hop.  Ties in magnitude go to
    the lower index, as ``jax.lax.top_k`` breaks them: a stable descending
    sort, not ``torch.topk``, whose tie order differs.
    """
    fraction: float = 0.25

    stateful = True

    def k_for(self, n) -> int:
        return max(1, int(math.ceil(self.fraction * numel(n))))

    def wire_bits(self, shape) -> int:
        m = numel(shape)
        idx_bits = max(1, math.ceil(math.log2(max(m, 2))))
        return self.k_for(m) * (32 + idx_bits)

    def init_state(self, shape, device=None):
        if isinstance(shape, (tuple, list, torch.Size)):
            shape = tuple(int(s) for s in shape)
        else:
            shape = (int(shape),)
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def encode(self, x, draws=None, state=None):
        shape = tuple(x.shape)
        if state is None:
            state = self.init_state(shape, x.device)
        y = (x.to(torch.float32) + state).reshape(-1)
        m = y.shape[0]
        order = torch.sort(y.abs(), descending=True, stable=True).indices
        idx = order[:self.k_for(m)]
        vals = y[idx]
        # out-of-place scatters (distinct indices: the bits of index_put),
        # which torch.func.vmap batches over a fleet of sessions
        dense = torch.zeros_like(y).scatter(0, idx, vals)
        return (vals, idx, shape), (y - dense).reshape(shape)

    def decode(self, wire):
        vals, idx, shape = wire
        dense = torch.zeros(numel(shape), dtype=torch.float32,
                            device=vals.device).scatter(0, idx, vals)
        return dense.reshape(shape)


CODECS = {
    "fp32": Fp32Codec,
    "fp16": Fp16Codec,
    "int8": lambda **kw: QuantCodec(bits=8, **kw),
    "int4": lambda **kw: QuantCodec(bits=4, **kw),
    "topk": TopKCodec,
}


def make_codec(name: str, **kw) -> Codec:
    """Codec registry lookup for CLI names."""
    if name not in CODECS:
        raise ValueError(f"unknown codec {name!r}; expected {sorted(CODECS)}")
    return CODECS[name](**kw)


# ===================================================================== channel
def channel_apply(codec, privacy, w: torch.Tensor, draws, state,
                  qmax=None):
    """One hop through the wire: DP noise on the outgoing payload (the
    draws' normals), then the codec roundtrip (the draws' uniforms, for a
    stochastic codec).  Returns (what the receiver decodes, codec state).
    ``draws`` is the hop's draw source: an eager hop's
    :class:`~repro_torch.comm.draws.HopDraws`, or in a compiled session
    the hop's slice of the draws taken before the program
    (:class:`~repro_torch.comm.draws.TensorHopDraws`), so nothing is drawn
    on the host inside the session.  ``qmax`` overrides a
    :class:`QuantCodec`'s range with a tensor (the quantization sweep's,
    ``core.compiled.quant_sweep_run``)."""
    if privacy is not None:
        if draws is None:
            raise ValueError("the Gaussian mechanism needs the hop's draws")
        w = privacy.apply(w, draws.normal(tuple(w.shape), w.device))
    if codec is not None:
        if qmax is not None:
            w, state = codec.roundtrip(w, draws, state, qmax=qmax)
        else:
            w, state = codec.roundtrip(w, draws, state)
    return w, state


def quant_bits_per_element(qmax) -> int:
    """Wire bits per element for a symmetric integer range [-qmax, qmax]
    (the inverse of QuantCodec.qmax): 127 -> 8, 7 -> 4."""
    return max(1, math.ceil(math.log2(2 * int(qmax) + 2)))

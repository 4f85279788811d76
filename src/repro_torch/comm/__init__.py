"""Wire-format subsystem: what crosses an agent boundary, in how many bits,
at what precision, and with what privacy noise.

Counterpart of ``repro/comm/``:

  * :mod:`repro_torch.comm.codecs`  -- encode/decode pairs (fp32/fp16,
    int8/int4 quantization on the CUDA quantize kernels, top-k
    sparsification with per-link error feedback) and ``channel_apply``;
  * :mod:`repro_torch.comm.budget`  -- per-link / per-session bit budgets,
    the degrade-then-skip :class:`~repro_torch.comm.budget.
    BudgetedTransport` and the serve engine's per-tenant
    :class:`~repro_torch.comm.budget.TenantBudget`;
  * :mod:`repro_torch.comm.privacy` -- the Gaussian mechanism with
    per-agent epsilon accounting;
  * :mod:`repro_torch.comm.draws`   -- the channel's random draws (no
    counterpart: the reference folds them from its session key).
"""
from repro_torch.comm.codecs import (CODECS, Codec, Fp16Codec, Fp32Codec,
                                     QuantCodec, TopKCodec, channel_apply,
                                     make_codec)
from repro_torch.comm.draws import ChannelDraws, HopDraws
from repro_torch.comm.privacy import GaussianMechanism, PrivacyAccountant

__all__ = [
    "CODECS", "Codec", "Fp16Codec", "Fp32Codec", "QuantCodec", "TopKCodec",
    "channel_apply", "make_codec", "ChannelDraws", "HopDraws",
    "GaussianMechanism", "PrivacyAccountant",
    # lazy (avoids importing the engine on package import):
    "BudgetSpec", "BudgetedTransport", "DEFAULT_LADDER", "MODEL_WEIGHT_BITS",
    "TenantBudget",
]


def __getattr__(name):      # PEP 562: budget pulls in the engine; keep lazy
    if name in ("BudgetSpec", "BudgetedTransport", "DEFAULT_LADDER",
                "MODEL_WEIGHT_BITS", "TenantBudget"):
        from repro_torch.comm import budget
        return getattr(budget, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

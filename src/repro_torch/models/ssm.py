"""Mamba2 SSD (state-space duality) block -- arXiv:2405.21060.

Counterpart of ``repro/models/ssm.py``, with its leaf names, its split
projections (z, x, B, C, dt each its own matrix) and its float32 leaves
(``A_log``, ``D``, ``dt_bias`` and the ``ssm`` state, whatever
``cfg.dtype`` is).  The scan is the chunked SSD form: an intra-chunk
quadratic (attention-like) term plus an inter-chunk state recurrence, a
plain loop over S / chunk steps.  Jamba's Mamba layers use the same block.

Decode carries an O(1) recurrent state per layer: the last conv - 1
inputs of the x, B and C streams and the SSM state [B, H, N, P]
(:class:`SSMState`).

Tensor parallelism (``tp``, a ``sharding.tp.TP``): ``in_z``, ``in_x``,
``in_dt``, ``conv_x`` and the gated norm's scale are this rank's slice of
``d_inner`` (its heads); ``in_B``, ``in_C``, their convs, ``A_log``,
``D`` and ``dt_bias`` stay whole (the rank reads its heads' entries of
the last three); the gated RMSNorm over ``d_inner`` all-reduces its sum
of squares; ``out_proj`` is row-parallel, its partial sums summed over
``model``.  The state holds the rank's slice of ``conv_x`` and of the SSM
heads, as ``rules.cache_specs`` lays them out.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import he_init, rmsnorm, rmsnorm_init


class SSMState(NamedTuple):
    conv_x: torch.Tensor       # [B, conv-1, d_inner]
    conv_B: torch.Tensor       # [B, conv-1, N]
    conv_C: torch.Tensor       # [B, conv-1, N]
    ssm: torch.Tensor          # [B, H, N, P] float32


def ssm_init(gen: torch.Generator | None, cfg: ArchConfig, dtype: torch.dtype,
             *, lead: tuple = (),
             device: torch.device | str = "meta") -> dict:
    d, n, conv = cfg.d_model, cfg.ssm_state, cfg.ssm_conv
    d_inner, h = cfg.d_inner, cfg.ssm_heads
    kw = dict(lead=lead, device=device)
    f32 = torch.float32

    def conv_w(width):
        w = torch.randn(lead + (conv, width), generator=gen, device=device)
        return (w / conv).to(dtype)

    # dt bias so that softplus(dt_bias) spans [1e-3, 1e-1] (mamba's rule)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand(lead + (h,), generator=gen, device=device) * (hi - lo) + lo
    dt = torch.exp(u)
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(torch.arange(1, h + 1, dtype=f32, device=device))
    return {
        "in_z": he_init(gen, (d, d_inner), dtype, **kw),
        "in_x": he_init(gen, (d, d_inner), dtype, **kw),
        "in_B": he_init(gen, (d, n), dtype, **kw),
        "in_C": he_init(gen, (d, n), dtype, **kw),
        "in_dt": he_init(gen, (d, h), dtype, **kw),
        "conv_x": conv_w(d_inner),
        "conv_x_bias": torch.zeros(lead + (d_inner,), dtype=dtype,
                                   device=device),
        "conv_B": conv_w(n),
        "conv_B_bias": torch.zeros(lead + (n,), dtype=dtype, device=device),
        "conv_C": conv_w(n),
        "conv_C_bias": torch.zeros(lead + (n,), dtype=dtype, device=device),
        "A_log": a_log.expand(lead + (h,)).clone(),
        "D": torch.ones(lead + (h,), dtype=f32, device=device),
        "dt_bias": dt_bias.to(f32),
        "norm": rmsnorm_init(d_inner, dtype, **kw),
        "out_proj": he_init(gen, (d_inner, d), dtype, fan_in=d_inner, **kw),
    }


def _conv_full(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
               conv: int) -> torch.Tensor:
    """Depthwise causal conv along S, silu-activated.  x [B, S, C]."""
    pad = F.pad(x, (0, 0, conv - 1, 0))
    s = x.shape[1]
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(conv))
    return F.silu(out + b)


def _conv_step(w: torch.Tensor, b: torch.Tensor, state: torch.Tensor,
               x_new: torch.Tensor):
    """One-token conv.  state [B, conv-1, C], x_new [B, 1, C] ->
    ([B, C], the next state)."""
    window = torch.cat([state, x_new], dim=1)                  # [B, conv, C]
    out = torch.einsum("bcd,cd->bd", window, w) + b
    return F.silu(out), window[:, 1:, :]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None):
    """Chunked SSD scan.

    x [b, s, h, p] (inputs, not yet dt-scaled), dt [b, s, h] float32,
    A_log [h], B/C [b, s, n] (one group).  Returns (y [b, s, h, p] float32,
    H_final [b, h, n, p] float32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    nc = s // chunk
    assert nc * chunk == s, (s, chunk)
    f32 = torch.float32
    a = -torch.exp(A_log.to(f32))                              # [h] < 0
    dA = dt * a                                                # [b, s, h]
    xc = (x.to(f32) * dt[..., None]).reshape(b, nc, chunk, h, p)
    dAc = dA.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n).to(f32)
    Cc = C.reshape(b, nc, chunk, n).to(f32)
    cum = torch.cumsum(dAc, dim=2)                             # [b, c, L, h]

    # intra-chunk (quadratic, attention-like) term
    cb = torch.einsum("bctn,bcsn->bcts", Cc, Bc)               # [b, c, L, L]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # [b,c,t,s,h]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # mask inside the exponent: for t < s the difference is positive and
    # exp overflows to inf (inf * 0 = NaN) if masked after
    seg = torch.where(mask[None, None, :, :, None], seg, -math.inf)
    m = cb[..., None] * torch.exp(seg)                         # [b,c,t,s,h]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m, xc)

    # chunk boundary states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [b, c, L, h]
    S = torch.einsum("bcln,bclhp,bclh->bchnp", Bc, xc, decay_to_end)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # [b, c, h]
    H = torch.zeros((b, h, n, p), dtype=f32, device=x.device) \
        if h0 is None else h0
    prev = []
    for c in range(nc):                      # the pre-state of each chunk
        prev.append(H)
        H = H * chunk_decay[:, c, :, None, None] + S[:, c]
    H_prev = torch.stack(prev, dim=1)                          # [b,c,h,n,p]

    # inter-chunk term
    y_inter = torch.einsum("bcln,bchnp,bclh->bclhp", Cc, H_prev,
                           torch.exp(cum))
    return (y_intra + y_inter).reshape(b, s, h, p), H


def _share(params: dict, cfg: ArchConfig, tp):
    """``tp`` when this rank holds a slice of ``d_inner``, else None."""
    if tp is None or params["in_x"].shape[-1] == cfg.d_inner:
        return None
    if params["in_dt"].shape[-1] == cfg.ssm_heads:
        raise NotImplementedError(
            f"{cfg.name}: d_inner {cfg.d_inner} splits over model "
            f"{tp.size} but its {cfg.ssm_heads} heads do not")
    return tp


def _heads(params: dict, tp) -> tuple:
    """A_log, D and dt_bias of this rank's heads."""
    leaves = (params["A_log"], params["D"], params["dt_bias"])
    if tp is None:
        return leaves
    from repro_torch.sharding import tp as tp_lib
    return tuple(tp_lib.chunk(tp_lib.shared(a, tp), tp, a.dim() - 1)
                 for a in leaves)


_WHOLE = ("in_B", "in_C", "conv_B", "conv_B_bias", "conv_C", "conv_C_bias")


def _local(params: dict, tp) -> dict:
    """The params as this rank uses them: the whole B/C streams' leaves
    through ``tp.shared`` (each rank's gradient is its heads' share)."""
    if tp is None:
        return params
    from repro_torch.sharding import tp as tp_lib
    return {k: tp_lib.shared(v, tp) if k in _WHOLE else v
            for k, v in params.items()}


def _project(params: dict, x: torch.Tensor, dt_bias: torch.Tensor):
    z = x @ params["in_z"]
    xs = x @ params["in_x"]
    B = x @ params["in_B"]
    C = x @ params["in_C"]
    dt = F.softplus((x @ params["in_dt"]).to(torch.float32)
                    + dt_bias)
    return z, xs, B, C, dt


def _out(params: dict, y: torch.Tensor, z: torch.Tensor,
         cfg: ArchConfig, tp=None) -> torch.Tensor:
    y = y * F.silu(z)
    if tp is None:
        y = rmsnorm(params["norm"], y, cfg.norm_eps)
    else:                       # the mean square over the whole d_inner
        from repro_torch.sharding import tp as tp_lib
        yf = y.to(torch.float32)
        ss = tp_lib.all_reduce_sum(yf.square().sum(-1, keepdim=True), tp)
        yf = yf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
        y = (yf * params["norm"]["scale"].to(torch.float32)).to(y.dtype)
    return y @ params["out_proj"]


def ssm_forward(params: dict, x: torch.Tensor, cfg: ArchConfig, tp=None,
                split: bool = False) -> tuple[torch.Tensor, SSMState]:
    """Full-sequence SSD block.  x [B, S, d] -> (y [B, S, d], final
    state); ``tp``, ``split``: this rank's share (module docstring)."""
    from repro_torch.sharding import tp as tp_lib
    share = _share(params, cfg, tp)
    params = _local(params, share)
    x = tp_lib.enter(x, tp, split, whole=share is None)
    b, s, _ = x.shape
    p, conv = cfg.ssm_head_dim, cfg.ssm_conv
    a_log, d_skip, dt_bias = _heads(params, share)
    z, xs_raw, B_raw, C_raw, dt = _project(params, x, dt_bias)
    d_inner = xs_raw.shape[-1]
    h = d_inner // p
    xs = _conv_full(params["conv_x"], params["conv_x_bias"], xs_raw, conv)
    B = _conv_full(params["conv_B"], params["conv_B_bias"], B_raw, conv)
    C = _conv_full(params["conv_C"], params["conv_C_bias"], C_raw, conv)
    xs = xs.reshape(b, s, h, p)
    y, H = ssd_chunked(xs, dt, a_log, B, C, min(cfg.ssm_chunk, s))
    y = y + d_skip[None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, s, d_inner).to(x.dtype)
    state = SSMState(conv_x=xs_raw[:, -(conv - 1):, :],
                     conv_B=B_raw[:, -(conv - 1):, :],
                     conv_C=C_raw[:, -(conv - 1):, :], ssm=H)
    return tp_lib.leave(_out(params, y, z, cfg, share), tp, split,
                        whole=share is None), state


def ssm_decode(params: dict, x: torch.Tensor, state: SSMState,
               cfg: ArchConfig, tp=None) -> tuple[torch.Tensor, SSMState]:
    """Single-token recurrent step.  x [B, 1, d] -> (y [B, 1, d], the next
    state); ``tp``: this rank's share (its slice of the state)."""
    from repro_torch.sharding import tp as tp_lib
    share = _share(params, cfg, tp)
    params = _local(params, share)
    x = tp_lib.enter(x, tp, False, whole=share is None)
    b, p = x.shape[0], cfg.ssm_head_dim
    f32 = torch.float32
    a_log, d_skip, dt_bias = _heads(params, share)
    z, xs_raw, B_raw, C_raw, dt = _project(params, x, dt_bias)
    d_inner = xs_raw.shape[-1]
    h = d_inner // p
    dt1 = dt[:, 0]                                             # [B, H]
    xs1, cx = _conv_step(params["conv_x"], params["conv_x_bias"],
                         state.conv_x, xs_raw)
    B1, cB = _conv_step(params["conv_B"], params["conv_B_bias"],
                        state.conv_B, B_raw)
    C1, cC = _conv_step(params["conv_C"], params["conv_C_bias"],
                        state.conv_C, C_raw)
    xs1 = xs1.reshape(b, h, p).to(f32)
    B1, C1 = B1.to(f32), C1.to(f32)
    a = -torch.exp(a_log.to(f32))
    dec = torch.exp(dt1 * a)                                   # [B, H]
    upd = torch.einsum("bn,bhp,bh->bhnp", B1, xs1, dt1)
    H = state.ssm * dec[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C1, H)
    y = y + d_skip[None, :, None] * xs1
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = tp_lib.leave(_out(params, y, z, cfg, share), tp, False,
                     whole=share is None)
    return y, SSMState(conv_x=cx, conv_B=cB, conv_C=cC, ssm=H)

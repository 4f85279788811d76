"""Compiled interchange rounds: a whole ASCII session as one fixed-shape
program, and a fleet of sessions as one batched program.

Counterpart of ``repro/core/compiled.py``, its synchronous lowering.  The
eager engine (:mod:`repro_torch.core.engine`) drives Algorithm 1 as a host
loop that reads alpha back after every fit to decide the stop; here the
round recurrence

    params_m = WST(X_m, y, w_t)             -> LearnerCore.fit
    r_i      = I{g_m(x_i) = y_i}            -> LearnerCore.predict
    alpha    = model_weight(w, r[, u])      -> scores.model_weight
    w_{t+1}  = reweight(w, r, alpha)        -> kernels.ops.ignorance_update

runs for every round and every agent with fixed shapes, and the alpha <= 0
stop (Algorithm 1, line 8) is a ``stopped`` mask: the fits run in every
round, and the mask freezes ``w`` (and the channel's state) once the stop
fired, as the reference's ``lax.scan`` does.  From its first launch to its
return a session reads nothing back to the host (no ``.item()``, no
``float(tensor)``, no boolean-mask indexing, no ``nonzero``): its draws are
taken before it (:func:`repro_torch.comm.draws.session_draws`), its
controller, budget and budget-aware order are tensors on the device, and
the result is read afterwards (:func:`fitted_from_result`, the engine's
replay of the ledger).  That is what lets a later change capture it in a
CUDA graph.

:func:`fleet_run` runs F sessions as one program: ``torch.func.vmap`` over
the session function, with per-session draws and shared or per-session
data.  The learners' fits take their gradients from ``torch.func.grad`` so
that vmap batches them, and the hop's kernels are custom ops whose vmap
rules launch once for all F sessions (``kernels/ops.py``): a fleet's
ignorance launches equal its hops, not hops x F.

:func:`make_serve_fn` lowers the plan's distributed prediction the same
way: every agent's score block, the serve channel (DP noise, the budget's
ladder walk or the serve controller's rung, the codec) and the head's
sum, with the draws taken first (:func:`repro_torch.comm.draws.
serve_draws`) and no host read.  :func:`serve_session` runs it for one
request, :func:`serve_batch` for a bucket of requests as one vmapped
program, whose block quantize is one launch for all slots.

``live=True`` adds the live plane's taps (:mod:`repro_torch.telemetry.
live`): one a round of each session and one a served request, each a
small int32 vector of what the body already computed (the round's bits
priced with the replay's formulas, hops sent and skipped, the exhaustion
edge), copied to the host without a read inside the program and folded
into the installed sink's ``live_*`` series.  Live programs are their
dark twins bit for bit and make the same launches of the hand-written
kernels; pricing and packing a tap add a few small device ops a round
(chip_smoke phase 17(b) counts them beside the tap copies).

:func:`async_session` lowers the stale-read async barrier
(:class:`AsyncStalePlan`, the eager ``AsyncStaleScheduler``): each round
every agent fits against one score, the positive alphas merge through
the unnormalized ignorance kernel, and under a channel one release a
round crosses it; the merge's ``alpha > 0`` test is a mask, not a host
read.  :func:`quant_sweep_run` sweeps a codec's range across sessions in
one vmapped program (the range a device operand of the quantize kernel,
one launch a hop for all sessions; ``serve_Xs`` adds the serve step), and
:func:`control_sweep_run` sweeps the controller's cuts and beta and the
budget's caps (``TRACE_COUNTS`` counts the sweep's builds).  Each sweep
row equals the static plan's run bit for bit.

PyTorch runs eagerly: "compiled" names the fixed-shape, host-read-free
program, not a compiler.  ``fleet_run(shard_axis=)`` spreads a fleet's
sessions over the ranks of a ``torch.distributed`` world and gathers
the result on every rank.

Quickstart::

    plan = plan_for(learners, num_classes=k, max_rounds=6)
    result = compiled_session(plan, 0, Xs, classes)
    fitted = fitted_from_result(plan, result, learners)    # FittedASCII
    fleet = fleet_run(plan, list(range(32)), Xs, classes)  # 32 sessions
    sweep = quant_sweep_run(plan_int8, [0] * 3, Xs, classes, [127, 31, 7])
    stale = async_session(dataclasses.replace(
        plan, scheduler=AsyncStalePlan()), 0, Xs, classes)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.comm.budget import MODEL_WEIGHT_BITS
from repro_torch.comm.codecs import QuantCodec, channel_apply
from repro_torch.comm.draws import (TensorHopDraws, serve_draws_batch,
                                    session_draws, stack_trees)
from repro_torch.control.scheduler import (REWARD_SMOOTHING,
                                           BudgetAwarePlan,
                                           reward_ema_tensor,
                                           traced_round_order)
from repro_torch.core import scores
from repro_torch.core.encoding import encode_labels
from repro_torch.core.engine import (LabelsMsg, SampleIdsMsg,
                                     key_data, tree_map)
from repro_torch.kernels import ignorance as _ig
from repro_torch.kernels import ops
from repro_torch.telemetry import live as live_plane
from repro_torch.telemetry.spans import tensor_leaves


# ========================================================================= plan
@dataclass(frozen=True)
class SessionPlan:
    """The static half of a session.  ``cores`` are the agents'
    :class:`~repro_torch.learners.base.LearnerCore` in chain order; the
    other fields mirror :class:`repro_torch.core.engine.SessionConfig` and
    the transport's wire channel: ``codec``, ``privacy``, ``budget`` (its
    ladder replaces ``codec``), ``serve_codec``, ``controller`` (a rung a
    hop from its EMA, which rides the session's state; with a budget, a
    floor on the ladder walk), ``serve_controller`` and ``scheduler`` (a
    :class:`~repro_torch.control.scheduler.BudgetAwarePlan`: the agents
    re-permuted every round in the program).
    The reference's ``use_kernel`` and ``kernel_interpret`` have no
    counterpart: every hop of the port runs ``kernels.ops``."""
    cores: tuple
    num_classes: int
    max_rounds: int = 20
    upstream: bool = True
    stop_on_negative_alpha: bool = True
    alpha_cap: float = 20.0
    exact_reweight: bool = False
    codec: Any = None
    privacy: Any = None
    budget: Any = None
    serve_codec: Any = None
    controller: Any = None
    serve_controller: Any = None
    scheduler: Any = None

    @property
    def num_agents(self) -> int:
        return len(self.cores)

    @property
    def ladder(self) -> tuple:
        """The codec rungs a hop evaluates: the budget's or the
        controller's ladder, else the one codec (None: no codec)."""
        if self.budget is not None:
            return self.budget.ladder
        if self.controller is not None:
            return self.controller.ladder
        return (self.codec,)

    @property
    def has_channel(self) -> bool:
        return (self.codec is not None or self.privacy is not None
                or self.budget is not None or self.controller is not None)

    @property
    def serve_ladder(self) -> tuple:
        """The rungs the serve step evaluates for an [n, K] block: the
        budget's ladder (the serve controller's too, when both are set),
        the serve controller's, else the one serve codec (the training
        codec when unset; None ships raw float32)."""
        if self.budget is not None:
            return self.budget.ladder
        if self.serve_controller is not None:
            return self.serve_controller.ladder
        return (self.serve_codec if self.serve_codec is not None
                else self.codec,)

    @property
    def has_serve_channel(self) -> bool:
        """Whether a served block crosses a channel (and takes draws)."""
        return (self.serve_ladder[0] is not None
                or self.serve_controller is not None
                or self.privacy is not None)


@dataclass(frozen=True)
class AsyncStalePlan:
    """Marker for the stale-read asynchronous lowering: rides
    ``SessionPlan.scheduler`` as a :class:`~repro_torch.control.scheduler.
    BudgetAwarePlan` does, and selects :func:`make_async_session_fn`
    (:func:`async_session`) instead of the sequential one.  No knobs: the
    clock skew comes from scenarios, which the compiled backend refuses."""


class SessionResult(NamedTuple):
    """Fixed-shape output of one session (with a leading [F] axis from
    :func:`fleet_run`).  ``alphas``/``accs`` [T, M]; ``executed`` marks the
    (round, slot) pairs the eager loop reaches, ``valid`` those that give a
    component; ``params`` is a length-M tuple of param trees with a
    leading round axis, slot j's without a scheduler, agent m's with one
    (its fit of the round, whichever slot it took); ``w_trace`` [T, M, n]
    the score after each slot;
    ``w`` the final score.  ``sent`` [T, M] marks hops that crossed the
    wire, ``codec_idx`` [T, M] their ladder rung (-1: not sent),
    ``exhausted`` whether the session budget ran dry; ``order`` [T, M] the
    agent of each slot (identity rows without a permuting scheduler).
    ``ctrl_ema`` is the controller's final EMA (1.0 without one), which the
    engine hands back to the transport, as the eager hops leave it."""
    alphas: torch.Tensor
    accs: torch.Tensor
    executed: torch.Tensor
    valid: torch.Tensor
    params: tuple
    w_trace: torch.Tensor
    w: torch.Tensor
    sent: torch.Tensor
    codec_idx: torch.Tensor
    exhausted: torch.Tensor
    order: torch.Tensor
    ctrl_ema: torch.Tensor


def plan_for(learners: Sequence, num_classes: int, *, max_rounds: int = 20,
             upstream: bool = True, stop_on_negative_alpha: bool = True,
             alpha_cap: float = 20.0, exact_reweight: bool = False,
             codec=None, privacy=None, budget=None, serve_codec=None,
             controller=None, serve_controller=None,
             scheduler=None) -> SessionPlan:
    """A SessionPlan from eager learners, which must all have a core
    (``functional``); the tree and the forest are eager-only."""
    cores = []
    for m, lr in enumerate(learners):
        core = lr.core(num_classes)
        if core is None:
            raise ValueError(
                f"agent {m}: {type(lr).__name__} has no LearnerCore "
                f"(functional=False): eager-only learners (tree/forest) "
                f"cannot ride the compiled backend")
        cores.append(core)
    if budget is not None or controller is not None:
        codec = None       # the budget's or the controller's ladder decides
    if (budget is not None and serve_controller is not None
            and tuple(serve_controller.ladder) != tuple(budget.ladder)):
        raise ValueError(
            "a serve controller on a budgeted plan must share the budget's "
            f"ladder, got {serve_controller.ladder} vs {budget.ladder}")
    return SessionPlan(cores=tuple(cores), num_classes=num_classes,
                       max_rounds=max_rounds, upstream=upstream,
                       stop_on_negative_alpha=stop_on_negative_alpha,
                       alpha_cap=alpha_cap, exact_reweight=exact_reweight,
                       codec=codec, privacy=privacy, budget=budget,
                       serve_codec=serve_codec, controller=controller,
                       serve_controller=serve_controller,
                       scheduler=scheduler)


# ==================================================================== lowering
def _make_reweight(plan: SessionPlan):
    """Eqs. (10)/(12): the exact-reweight surrogate (plain ops in both
    packages), else ``kernels.ops.ignorance_update``.  The reference picks
    its Pallas kernel only on the mesh-ring transport (``use_kernel``);
    the port's kernel and its plain version are bit-equal, so every hop
    of the port calls ``ops``, as the eager transports do."""
    if plan.exact_reweight:
        k = plan.num_classes
        return lambda w, r, a: scores.ignorance_update_exact(w, r, a, k)
    return ops.ignorance_update


_INT32_MAX = 2 ** 31 - 1


def _full(value: int, like: torch.Tensor) -> torch.Tensor:
    """A 0-d int64 tensor on ``like``'s device, filled there."""
    return torch.full((), value, dtype=torch.int64, device=like.device)


def ladder_walk(costs, rem: torch.Tensor, floor=None) -> torch.Tensor:
    """The degrade-then-skip ladder walk as tensors (the twin of
    :meth:`repro_torch.comm.budget.BudgetSpec.choose_costs`): the first
    rung from ``floor`` on whose cost (``costs``: ints, best rung first)
    fits the remaining ``rem`` bits, -1 for a skip; 0-d int64."""
    rung = _full(-1, rem)
    for i in reversed(range(len(costs))):
        ok = rem >= int(costs[i])
        if floor is not None:
            ok = ok & (floor <= i)
        rung = torch.where(ok, _full(i, rem), rung)
    return rung


def rung_select(rung: torch.Tensor, values: Sequence[torch.Tensor],
                default: torch.Tensor) -> torch.Tensor:
    """``values[rung]``, ``default`` at rung -1; a one-rung ladder is its
    rung."""
    if len(values) == 1:
        return values[0]
    out = default
    for i in reversed(range(len(values))):
        out = torch.where(rung == i, values[i], out)
    return out


def _pick(x: torch.Tensor, i) -> torch.Tensor:
    """``x[i]`` for an int or a 0-d index tensor (a gather, no host read)."""
    if isinstance(i, int):
        return x[i]
    return torch.index_select(x, 0, i.reshape(1)).squeeze(0)


def _put(x: torch.Tensor, i, value: torch.Tensor,
         mask: torch.Tensor) -> torch.Tensor:
    """``x`` with row ``i`` set to ``value`` where ``mask``, out of
    place."""
    hit = torch.arange(x.shape[0], device=x.device) == i
    hit = hit.reshape(-1, *([1] * (x.dim() - 1))) & mask
    return torch.where(hit, value, x)


class SlotDraws:
    """A fit's draws taken ahead, handed to ``LearnerCore.fit`` in its
    ``key`` slot: ``randint`` returns step i's minibatch rows."""

    def __init__(self, rows: torch.Tensor | None) -> None:
        self.rows = rows

    def randint(self, shape, high, step, device=None) -> torch.Tensor:
        return self.rows[step]


def _check_lowering(plan: SessionPlan, feature_shapes: tuple) -> None:
    """The sequential lowering's argument rules, but for the budget's caps
    (:func:`_check_caps`, which a control sweep's operands replace)."""
    if len(feature_shapes) != plan.num_agents:
        raise ValueError(f"{plan.num_agents} cores but "
                         f"{len(feature_shapes)} feature shapes")
    scheduler = plan.scheduler
    if scheduler is not None:
        if not isinstance(scheduler, BudgetAwarePlan):
            raise ValueError(
                f"SessionPlan.scheduler must be a BudgetAwarePlan for the "
                f"sequential lowering, got {type(scheduler).__name__} "
                f"(an AsyncStalePlan lowers through async_session)")
        if scheduler.spend_signal == "link" and plan.budget is None:
            raise ValueError("spend_signal='link' orders by budgeted link "
                             "spend, but the plan has no budget")


def _check_caps(budget) -> None:
    if budget is None:
        return
    for cap in (budget.session_bits, budget.link_bits):
        if cap is not None and cap >= _INT32_MAX:
            raise ValueError(f"budget caps must fit int32 (the "
                             f"reference's spend counters), got {cap}")


def _check_sweep(plan: SessionPlan, qmax_arg: bool,
                 control_arg: bool) -> None:
    """The reference's rules for the two sweep modes."""
    if qmax_arg:
        if plan.budget is not None or plan.controller is not None \
                or not isinstance(plan.codec, QuantCodec):
            raise ValueError("qmax_arg sweeps need a plain QuantCodec plan")
    if control_arg:
        if qmax_arg:
            raise ValueError("qmax_arg and control_arg are separate sweep "
                             "modes; pick one")
        if plan.budget is None and plan.controller is None:
            raise ValueError("control_arg sweeps trace controller cuts/beta "
                             "and budget caps; the plan has neither")


def _cap(cap, like: torch.Tensor) -> torch.Tensor:
    """A budget cap as a 0-d int64 tensor: a static int filled on the
    device, or a sweep's traced cap (the int32 sentinel for none)."""
    if isinstance(cap, torch.Tensor):
        return cap.to(torch.int64)
    return _full(cap, like)


#: Builds of a sweep's session function, by family: a control sweep builds
#: one, whatever its number of configs (the port has no tracer; the
#: reference counts traces, one a compile).
TRACE_COUNTS: dict = {}


def make_session_fn(plan: SessionPlan, feature_shapes: tuple,
                    qmax_arg: bool = False, control_arg: bool = False,
                    live: bool = False):
    """Lower ``plan`` for the agents' feature shapes into

        session_fn(draws, Xs, classes) -> SessionResult

    a fixed-shape function of the session's draws
    (:func:`repro_torch.comm.draws.session_draws`), the feature blocks and
    the labels: rounds and agents unrolled, the stop a mask, no read to the
    host.  It vmaps (:func:`fleet_run`).  With a channel it carries the
    senders' codec residuals, the budget's spend and the controller's EMA;
    with a budget-aware scheduler the agents' spend and reward EMAs, and it
    re-permutes the agents each round as the eager scheduler would.  The
    permutation is known only on the device, so each slot fits every agent
    on its own block with the slot's draws and selects the slot's agent's
    fit: M fits a slot.  That also lowers agents that differ (cores or
    feature widths), which the reference refuses; its gather over stacked
    agent data takes equal agents only.
    ``live`` stages one round tap a round (:func:`repro_torch.telemetry.
    live.emit_round`): the round, whether it ran, its bits priced as the
    replay books them (a shipped hop's encoded score and its 32-bit
    alpha, the collation setup in round 0), the hops sent and skipped, and
    whether the budget ran dry in it.
    ``qmax_arg`` makes a plain :class:`~repro_torch.comm.codecs.
    QuantCodec` plan's range an operand, ``session_fn(draws, Xs, classes,
    qmax)`` with ``qmax`` a 0-d float32 tensor, so that a codec sweep
    vmaps into one program (:func:`quant_sweep_run`: each hop's quantize
    is one launch for all sessions, each at its range).  ``control_arg``
    makes the control plane operands instead, ``session_fn(draws, Xs,
    classes, cuts, beta, session_cap, link_cap)``: the controller's cuts
    [R - 1] and beta (float32) and the budget's caps (int, ``_INT32_MAX``
    for none), so that a controller or budget sweep vmaps too
    (:func:`control_sweep_run`).  Under ``control_arg`` the budget's
    session and link terms are always traced, the sentinel standing for an
    uncapped one; a row at the sentinel gives the uncapped plan's bits.
    ``TRACE_COUNTS['control_sweep']`` counts the ``control_arg`` builds."""
    _check_sweep(plan, qmax_arg, control_arg)
    _check_lowering(plan, feature_shapes)
    if control_arg:
        TRACE_COUNTS["control_sweep"] = TRACE_COUNTS.get("control_sweep",
                                                         0) + 1
    else:
        _check_caps(plan.budget)
    operands = (("qmax",) if qmax_arg else
                ("cuts", "beta", "session_cap", "link_cap") if control_arg
                else ())
    k = plan.num_classes
    cores = plan.cores
    num = plan.num_agents
    codec, privacy, budget = plan.codec, plan.privacy, plan.budget
    controller, scheduler = plan.controller, plan.scheduler
    ladder = plan.ladder
    has_channel = plan.has_channel
    stateful = codec is not None and codec.stateful
    reweight = _make_reweight(plan)
    # which budget terms the program traces: the plan's caps, or every
    # term under a control sweep (its caps are operands)
    capped_s = budget is not None and (control_arg
                                       or budget.session_bits is not None)
    capped_l = budget is not None and (control_arg
                                       or budget.link_bits is not None)

    def session_fn(draws: dict, Xs: tuple, classes: torch.Tensor,
                   *args) -> SessionResult:
        if len(args) != len(operands):
            raise TypeError(f"session_fn takes (draws, Xs, classes"
                            f"{''.join(', ' + o for o in operands)}), got "
                            f"{len(args)} operands after classes")
        sweep = dict(zip(operands, args))
        if not control_arg:
            sweep["session_cap"] = getattr(budget, "session_bits", None)
            sweep["link_cap"] = getattr(budget, "link_bits", None)
        classes = classes.to(torch.int64)
        n = classes.shape[0]
        dev = classes.device
        onehot = (classes[:, None] == torch.arange(k, device=dev)).to(
            torch.float32)
        w = scores.init_ignorance(n, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        stopped = false
        carry: dict = {}
        if stateful:
            carry["resid"] = torch.zeros((num, n), dtype=torch.float32,
                                         device=dev)
        if controller is not None:
            carry["ctrl"] = torch.ones((), dtype=torch.float32, device=dev)
        if budget is not None:
            costs = budget.hop_costs(n)
            setup_bits = (num - 1) * (LabelsMsg("", "", n).bits
                                      + SampleIdsMsg("", "", n).bits)
            carry["spent"] = _full(setup_bits, w)
            carry["link"] = torch.zeros(
                (num, num) if scheduler is not None else (num,),
                dtype=torch.int64, device=dev)
            carry["exhausted"] = false
        if scheduler is not None:
            ids = torch.arange(num, device=dev)
            carry["ema"] = torch.zeros(num, dtype=torch.float32, device=dev)
            carry["seen"] = torch.zeros(num, dtype=torch.bool, device=dev)
            if scheduler.spend_signal == "wire":
                # what TransportLog.bits_by_src tallies for a shipped hop:
                # its ignorance wire bits and the 32-bit ModelWeightMsg
                wire_costs = tuple(
                    (c.wire_bits(n) if c is not None else n * 32)
                    + MODEL_WEIGHT_BITS for c in ladder)
                carry["wire"] = torch.zeros(num, dtype=torch.int64,
                                            device=dev)
        if live:
            live_setup = (num - 1) * (LabelsMsg("", "", n).bits
                                      + SampleIdsMsg("", "", n).bits)
            # a shipped hop's price at each rung: the replay's
            # IgnoranceMsg (encoded, or raw float32) and ModelWeightMsg
            if budget is not None:
                live_costs = budget.hop_costs(n)
            else:
                live_costs = tuple(
                    (c.wire_bits(n) if c is not None else n * 32)
                    + MODEL_WEIGHT_BITS for c in ladder)
            # a draw of the session, which a fleet's vmap batches
            salt = next(tensor_leaves(draws))
        outs, agent_params = [], []
        for t in range(plan.max_rounds):
            u = torch.ones(n, dtype=torch.float32, device=dev)
            if live:
                live_active = ~stopped
                entry_exh = carry.get("exhausted", false)
                live_bits = live_sent = live_skip = _full(0, w)
            if scheduler is not None:
                # the round's permutation from the carried signal, taken at
                # round entry as the eager scheduler reads its transport
                if scheduler.spend_signal == "link":
                    spent_sig = carry["link"].sum(dim=1)
                elif scheduler.spend_signal == "wire":
                    spent_sig = carry["wire"]
                else:
                    spent_sig = torch.zeros(num, dtype=torch.int64,
                                            device=dev)
                perm = traced_round_order(spent_sig, carry["ema"]).to(
                    torch.int64)
            row = []
            for j, core in enumerate(cores):
                slot = tree_map(lambda x, _t=t: x[_t], draws["fit"][j])
                if scheduler is None:
                    src, dst = j, (j + 1) % num
                    params, r = _fit(core, slot, Xs[j], onehot, w, classes)
                    cand = None
                else:
                    # every agent fits on its own block with the slot's
                    # draws; the slot's agent's fit is selected
                    src, dst = perm[j], perm[(j + 1) % num]
                    fits = [_fit(cores[m], slot[m], Xs[m], onehot, w,
                                 classes) for m in range(num)]
                    cand = [p for p, _ in fits]
                    r = fits[0][1]
                    for m in range(1, num):
                        r = torch.where(src == m, fits[m][1], r)
                    params = None
                a, rbar = scores.model_weight(
                    w, r, k, u=u if plan.upstream and j > 0 else None,
                    alpha_cap=plan.alpha_cap)
                executed = ~stopped
                trigger = (executed & (a <= 0) if plan.stop_on_negative_alpha
                           else false)
                valid = executed & ~trigger
                if scheduler is not None:
                    # the eager loop observes every fit it reaches, the
                    # stop's included
                    prev = _pick(carry["ema"], src)
                    upd = reward_ema_tensor(REWARD_SMOOTHING, prev, rbar,
                                            ~_pick(carry["seen"], src))
                    carry["ema"] = _put(carry["ema"], src, upd, executed)
                    carry["seen"] = _put(carry["seen"], src, executed,
                                         executed)
                # only a slot that gives a component moves u and w
                u = torch.where(valid,
                                scores.upstream_factor_update(u, a, r, k), u)
                w_upd = reweight(w, r, a)
                if not has_channel:
                    sent = valid
                    rung = torch.where(sent, _full(0, w), _full(-1, w))
                    w = torch.where(valid, w_upd, w)
                else:
                    w, sent, rung = _channel_hop(
                        carry, t, j, src, dst, w, w_upd, valid, draws,
                        scheduler is not None, **sweep)
                if scheduler is not None and scheduler.spend_signal == "wire":
                    wcost = rung_select(rung, [_full(c, w)
                                               for c in wire_costs],
                                        _full(0, w))
                    add = torch.where(sent, wcost, _full(0, w))
                    carry["wire"] = carry["wire"] + torch.where(
                        ids == src, add, _full(0, w))
                if live:
                    cost = rung_select(rung, [_full(c, w)
                                              for c in live_costs],
                                       _full(0, w))
                    live_bits = live_bits + torch.where(sent, cost,
                                                        _full(0, w))
                    live_sent = live_sent + sent.to(torch.int64)
                    live_skip = live_skip + (valid & ~sent).to(torch.int64)
                stopped = stopped | trigger
                row.append((params, a, rbar, executed, valid, w, sent, rung,
                            src if scheduler is not None else _full(j, w),
                            cand))
            if capped_s:
                # the eager engine sees the exhaustion at the next round's
                # entry: this round finishes, later ones never start
                stopped = stopped | carry["exhausted"]
            if live:
                live_plane.emit_round(
                    salt, t, live_active,
                    live_bits + (live_setup if t == 0 else 0), live_sent,
                    live_skip, carry.get("exhausted", false) & ~entry_exh)
            outs.append(row)
            if scheduler is not None:
                # agent m's fit of the round: the one of the slot it took
                agent_params.append([_select_agent(row, perm, m)
                                     for m in range(num)])

        def stack(i):
            return torch.stack([torch.stack([row[j][i] for j in range(num)])
                                for row in outs])

        return SessionResult(
            alphas=stack(1), accs=stack(2), executed=stack(3),
            valid=stack(4),
            params=tuple(stack_trees(
                [row[j][0] for row in outs] if scheduler is None
                else [ap[j] for ap in agent_params]) for j in range(num)),
            w_trace=stack(5), w=w, sent=stack(6), codec_idx=stack(7),
            exhausted=carry.get("exhausted", false), order=stack(8),
            ctrl_ema=carry.get("ctrl", torch.ones((), dtype=torch.float32,
                                                  device=dev)))

    def _channel_hop(carry, t, j, src, dst, w, w_upd, valid, draws,
                     permuted, qmax=None, cuts=None, beta=None,
                     session_cap=None, link_cap=None):
        """The wire of one hop: the controller's and the budget's rung, DP
        noise, the codec (every rung evaluated, one selected), the
        residual, the spend.  ``qmax``, ``cuts`` and ``beta`` are a sweep's
        operands (None where the plan's static values hold); the caps are
        the plan's or a control sweep's.  Returns (w after the hop, sent,
        rung)."""
        if controller is not None:
            # the EMA advances on every hop the eager loop interchanges
            c_rung, ctrl_new = controller.step_tensor(
                w, w_upd, carry["ctrl"], cuts=cuts, beta=beta)
            carry["ctrl"] = torch.where(valid, ctrl_new, carry["ctrl"])
        if budget is not None:
            n = w.shape[0]
            costs = budget.hop_costs(n)
            rem = _full(_INT32_MAX, w)
            if capped_s:
                rem_s = _cap(session_cap, w) - carry["spent"]
                rem = torch.minimum(rem, rem_s)
            if capped_l:
                link_spent = (_pick(carry["link"].reshape(-1),
                                    src * num + dst) if permuted
                              else carry["link"][j])
                rem = torch.minimum(rem, _cap(link_cap, w) - link_spent)
            # the controller's rung is a floor on the walk: never finer
            rung = ladder_walk(costs, rem, floor=(
                c_rung if controller is not None else None))
            sendable = rung >= 0
        elif controller is not None:
            rung, sendable = c_rung, torch.ones_like(valid)
        else:
            rung, sendable = _full(0, w), torch.ones_like(valid)
        state = _pick(carry["resid"], src) if stateful else None
        hop = TensorHopDraws(draws["u"][t, j] if "u" in draws else None,
                             draws["z"][t, j] if "z" in draws else None)
        # the noise does not depend on the rung (one draw, one input):
        # apply it once, then each rung's codec, as the reference does;
        # the same bits as the eager hop's fused channel at its rung
        w_noised, _ = channel_apply(None, privacy, w_upd, hop, None)
        pairs = [channel_apply(c, None, w_noised, hop, state, qmax=qmax)
                 for c in ladder]
        w_chan = rung_select(rung, [p[0] for p in pairs], w_upd)
        sent = valid & sendable
        w = torch.where(sent, w_chan, w)
        if stateful:
            # error-feedback residuals are per sender
            carry["resid"] = _put(carry["resid"], src, pairs[0][1], sent)
        if budget is not None:
            cost = rung_select(rung, [_full(c, w) for c in costs],
                               _full(0, w))
            add = torch.where(sent, cost, _full(0, w))
            carry["spent"] = carry["spent"] + add
            if permuted:
                flat = torch.arange(num * num, device=w.device) == (
                    src * num + dst)
                carry["link"] = carry["link"] + torch.where(
                    flat, add, _full(0, w)).reshape(num, num)
            else:
                carry["link"] = carry["link"] + torch.where(
                    torch.arange(num, device=w.device) == j, add,
                    _full(0, w))
            if capped_s:
                carry["exhausted"] = carry["exhausted"] | (
                    valid & (rem_s < min(costs)))
        rung = torch.where(sent, rung, _full(-1, w))
        return w, sent, rung

    return session_fn


def _fit(core, slot: dict, X, onehot, w, classes):
    """One fit from a slot's draws, and its reward vector."""
    params = core.fit(slot["init"], SlotDraws(slot.get("rows")), X, onehot,
                      w)
    return params, (core.predict(params, X) == classes).to(torch.float32)


def _select_agent(row: list, perm: torch.Tensor, m: int):
    """Agent m's params in a permuted round: slot j's candidate for m where
    the round put m in slot j."""
    out = row[0][9][m]
    for j in range(1, len(row)):
        out = tree_map(lambda a, b, _j=j: torch.where(perm[_j] == m, b, a),
                       out, row[j][9][m])
    return out


def _draws_for(plan: SessionPlan, keys, n: int, feature_shapes: tuple,
               device, source, fleet: bool) -> dict:
    """Every draw the plan's sessions read (see ``session_draws``): slot
    j's fit draws for its core, or for every agent's under a permuting
    scheduler (each slot fits every agent); under an
    :class:`AsyncStalePlan` agent j's fits and each round's barrier
    release's channel draws, as the eager barrier takes them."""
    stochastic = any(getattr(c, "stochastic", False) for c in plan.ladder
                     if c is not None)
    barrier = isinstance(plan.scheduler, AsyncStalePlan)
    if plan.scheduler is not None and not barrier:
        def fit(j, fd):
            return [core.draw(fd, shape, n)
                    for core, shape in zip(plan.cores, feature_shapes)]
    else:
        def fit(j, fd):
            return plan.cores[j].draw(fd, feature_shapes[j], n)
    return session_draws(
        keys, plan.max_rounds, plan.num_agents, n, fit,
        uniform=stochastic, normal=plan.privacy is not None, device=device,
        source=source, fleet=fleet, barrier=barrier)


def compiled_session(plan: SessionPlan, key, Xs: Sequence[torch.Tensor],
                     classes: torch.Tensor, *, live: bool = False,
                     source=None) -> SessionResult:
    """One session as one fixed-shape program: its draws taken first
    (``key``: an int seed or uint32 key data; ``source``: the draw source,
    default :class:`~repro_torch.comm.draws.ChannelDraws`), then the
    program, which reads nothing back to the host.  ``live``: its round
    taps go to the sink :func:`repro_torch.telemetry.live.installed`
    routes them to."""
    Xs = tuple(Xs)
    shapes = tuple(tuple(x.shape[1:]) for x in Xs)
    fn = make_session_fn(plan, shapes, live=live)
    draws = _draws_for(plan, key_data(key), int(classes.shape[0]), shapes,
                       classes.device, source, fleet=False)
    return fn(draws, Xs, classes)


def fleet_run(plan: SessionPlan, keys, Xs: Sequence[torch.Tensor],
              classes: torch.Tensor, *, data_batched: bool = False,
              shard_axis: str | None = None, live: bool = False,
              source=None) -> SessionResult:
    """A fleet of sessions as one batched program (``torch.func.vmap`` over
    the session function).  ``keys``: F session keys (int seeds or uint32
    key data).  With ``data_batched`` False every session sees the same
    (Xs, classes); with True ``Xs[m]`` is [F, n, p_m] and ``classes``
    [F, n].  ``source``: the draw source, or one a key.  Returns a
    SessionResult with a leading [F] axis; session f equals
    :func:`compiled_session` with ``keys[f]`` within what batched matrix
    products change (see tests/test_torch_compiled.py).  ``live``: one
    round tap a session and round, a round's F taps staged as one copy
    (the tap's vmap rule).  ``shard_axis`` names the axis the fleet is
    sharded over: every rank of the initialised ``torch.distributed``
    world (its size must divide F) takes the same keys and cohort, runs
    the sessions of its slice, and the results are all-gathered, so each
    rank returns the whole [F] result, as the reference's global array
    (``nccl`` for CUDA tensors, ``gloo`` for CPU ones; with ``live`` it
    raises, as the reference does)."""
    if shard_axis is not None:
        if live:
            raise ValueError("live emission does not compose with sharded "
                             "fleets: run --watch fleets unsharded")
        return _sharded_fleet(plan, keys, Xs, classes, data_batched, source)
    Xs = tuple(Xs)
    shapes = tuple(tuple(x.shape[2:] if data_batched else x.shape[1:])
                   for x in Xs)
    n = int(classes.shape[-1])
    fn = make_session_fn(plan, shapes, live=live)
    draws = _draws_for(plan, [key_data(k) for k in keys], n, shapes,
                       classes.device, source, fleet=True)
    data_ax = 0 if data_batched else None
    return torch.func.vmap(fn, in_dims=(0, data_ax, data_ax))(draws, Xs,
                                                              classes)


def _sharded_fleet(plan: SessionPlan, keys, Xs, classes: torch.Tensor,
                   data_batched: bool, source) -> SessionResult:
    """:func:`fleet_run` of this rank's slice of the sessions, every field
    all-gathered over the world."""
    import torch.distributed as dist
    from repro_torch.sharding.context import BACKENDS
    if not dist.is_initialized():
        raise RuntimeError("fleet_run(shard_axis=) needs an initialised "
                           "process group")
    want = BACKENDS.get(classes.device.type)
    if dist.get_backend() != want:
        raise RuntimeError(f"a fleet on {classes.device.type} gathers over "
                           f"{want}, but the world runs "
                           f"{dist.get_backend()}")
    keys, world = list(keys), dist.get_world_size()
    if len(keys) % world:
        raise ValueError(f"{world} ranks do not divide a fleet of "
                         f"{len(keys)} sessions")
    per = len(keys) // world
    cut = slice(dist.get_rank() * per, (dist.get_rank() + 1) * per)
    if data_batched:
        Xs, classes = tuple(x[cut] for x in Xs), classes[cut]
    if isinstance(source, (list, tuple)):
        source = list(source)[cut]
    local = fleet_run(plan, keys[cut], Xs, classes,
                      data_batched=data_batched, source=source)

    def gather(x: torch.Tensor) -> torch.Tensor:
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(wire) for _ in range(world)]
        dist.all_gather(parts, wire)
        return torch.cat(parts).to(x.dtype)

    return SessionResult(*(tree_map(gather, field) for field in local))


# ================================================================ async barrier
class AsyncSessionResult(NamedTuple):
    """Fixed-shape output of one compiled async session, agent-major (the
    barrier has no chain order).  ``alphas``/``accs``/``executed``/
    ``valid`` [T, M] and ``params`` (a tree a agent, leading round axis)
    as :class:`SessionResult`'s; ``executed`` rows are all True or all
    False, ``valid`` the positive alphas of executed rounds.  ``w_trace``
    [T, M, n] the running merge after agent m (what a channel-less
    barrier's IgnoranceMsgs carry); ``w_bar`` [T, n] the release as
    published (after DP noise and the codec, under a channel); ``sent``
    [T] whether the barrier released (a budget skip False); ``codec_idx``
    [T] its rung (-1: raw or skipped); ``exhausted`` whether the session
    budget ran dry."""
    alphas: torch.Tensor
    accs: torch.Tensor
    executed: torch.Tensor
    valid: torch.Tensor
    params: tuple
    w_trace: torch.Tensor
    w_bar: torch.Tensor
    w: torch.Tensor
    sent: torch.Tensor
    codec_idx: torch.Tensor
    exhausted: torch.Tensor


def make_async_session_fn(plan: SessionPlan, feature_shapes: tuple,
                          live: bool = False):
    """Lower the stale-read async barrier (``AsyncStaleScheduler``) into

        session_fn(draws, Xs, classes) -> AsyncSessionResult

    a fixed-shape function of the session's draws (:func:`_draws_for`'s
    async layout: agent j's fits, each round's barrier draws), the feature
    blocks and the labels, rounds and agents unrolled, no read to the host.

    A round is the eager ``Session._step_stale``: every agent fits against
    the round's score, then each positive alpha's update merges in agent
    order through the unnormalized ignorance kernel
    (``ops.ignorance_update_unnormalized(w_next, r, a / M)``) and the
    product is normalized at the barrier (``ops.ignorance_normalize``),
    the sum from the last merge's tile sums.  Where the eager loop tests
    ``alpha <= 0`` on the host and skips the merge, the program runs every
    merge and selects it by ``executed & (a > 0)``, the partial sums
    carried through the same masks; a round with no positive alpha
    normalizes with the score's own tile sums, as the eager
    ``partials=None`` does.  Under a channel the release is the channel
    point: DP noise once, then each rung's codec (the quantize kernel on
    the vector), and under a budget one session-level ladder walk over
    the bare payload costs after the round's alpha messages are booked; a
    skipped release leaves the score stale.  ``live``: one round tap a
    round, priced as the async replay books it (each positive agent's
    alpha, and its raw score without a channel, else the release at its
    rung)."""
    if len(feature_shapes) != plan.num_agents:
        raise ValueError(f"{plan.num_agents} cores but "
                         f"{len(feature_shapes)} feature shapes")
    if plan.controller is not None:
        raise ValueError("adaptive controllers do not apply to the async "
                         "barrier (its EMA statistic is defined on per-hop "
                         "interchange, which the barrier path has none of)")
    k = plan.num_classes
    cores = plan.cores
    num = plan.num_agents
    codec, privacy, budget = plan.codec, plan.privacy, plan.budget
    ladder = plan.ladder
    has_channel = plan.has_channel
    stateful = codec is not None and codec.stateful
    capped_s = budget is not None and budget.session_bits is not None
    _check_caps(budget)

    def session_fn(draws: dict, Xs: tuple, classes: torch.Tensor
                   ) -> AsyncSessionResult:
        classes = classes.to(torch.int64)
        n = classes.shape[0]
        dev = classes.device
        onehot = (classes[:, None] == torch.arange(k, device=dev)).to(
            torch.float32)
        w = scores.init_ignorance(n, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        stopped = false
        carry: dict = {}
        if stateful:
            carry["resid"] = torch.zeros(n, dtype=torch.float32, device=dev)
        setup_bits = (num - 1) * (LabelsMsg("", "", n).bits
                                  + SampleIdsMsg("", "", n).bits)
        if budget is not None:
            costs = budget.payload_costs(n)
            carry["spent"] = _full(setup_bits, w)
            carry["exhausted"] = false
        if live:
            # the release's price at each rung: what the async replay books
            # for the barrier's IgnoranceMsg (encoded, or raw float32)
            live_costs = (budget.payload_costs(n) if budget is not None
                          else tuple(c.wire_bits(n) if c is not None
                                     else n * 32 for c in ladder))
            salt = next(tensor_leaves(draws))
        rows, bars, sents, rungs = [], [], [], []
        for t in range(plan.max_rounds):
            executed = ~stopped
            entry_exh = carry.get("exhausted", false)
            fits = []
            for j, core in enumerate(cores):
                slot = tree_map(lambda x, _t=t: x[_t], draws["fit"][j])
                params, r = _fit(core, slot, Xs[j], onehot, w, classes)
                a, rbar = scores.model_weight(w, r, k,
                                              alpha_cap=plan.alpha_cap)
                fits.append((params, r, a, rbar))
            # the damped merge in agent order, every merge run and the
            # positive ones selected; the tile sums ride the same masks
            w_next, partials = w, _ig.tile_sums(w)
            any_pos, pos_count = false, _full(0, w)
            row = []
            for params, r, a, rbar in fits:
                use = executed & (a > 0)
                w_upd, p_upd = ops.ignorance_update_unnormalized(
                    w_next, r, a / num)
                w_next = torch.where(use, w_upd, w_next)
                partials = torch.where(use, p_upd, partials)
                any_pos = any_pos | use
                pos_count = pos_count + use.to(torch.int64)
                row.append((params, a, rbar, executed, use, w_next))
            w_bar = ops.ignorance_normalize(w_next, partials)
            if not has_channel:
                released, sent, rung = w_bar, executed, _full(-1, w)
                w = torch.where(executed, w_bar, w)
            else:
                if budget is not None:
                    # the alpha messages book before the walk reads the
                    # ledger, as the eager merge sends them first; no link
                    # cap: the barrier is a broadcast
                    carry["spent"] = carry["spent"] + 32 * pos_count
                    rem_s = _full(_INT32_MAX, w)
                    if capped_s:
                        rem_s = _full(budget.session_bits, w) - carry["spent"]
                        carry["exhausted"] = carry["exhausted"] | (
                            executed & (rem_s < min(costs)))
                    rung = ladder_walk(costs, rem_s)
                    sendable = rung >= 0
                else:
                    rung, sendable = _full(0, w), torch.ones_like(executed)
                state = carry["resid"] if stateful else None
                hop = TensorHopDraws(draws["u"][t] if "u" in draws else None,
                                     draws["z"][t] if "z" in draws else None)
                # noise once (it does not depend on the rung), then each
                # rung's codec: the eager release's fused channel's bits
                noised, _ = channel_apply(None, privacy, w_bar, hop, None)
                pairs = [channel_apply(c, None, noised, hop, state)
                         for c in ladder]
                released = rung_select(rung, [p[0] for p in pairs], w_bar)
                sent = executed & sendable
                w = torch.where(sent, released, w)
                if stateful:
                    carry["resid"] = torch.where(sent, pairs[0][1], state)
                if budget is not None:
                    cost = rung_select(rung, [_full(c, w) for c in costs],
                                       _full(0, w))
                    carry["spent"] = carry["spent"] + torch.where(
                        sent, cost, _full(0, w))
                rung = torch.where(sent, rung, _full(-1, w))
            if plan.stop_on_negative_alpha:
                stopped = stopped | (executed & ~any_pos)
            if capped_s:
                # seen at the next round's entry, as the eager engine does
                stopped = stopped | carry["exhausted"]
            if live:
                if not has_channel:
                    # each positive agent's raw score and its alpha
                    bits = pos_count * (n * 32 + MODEL_WEIGHT_BITS)
                    ign, skip = pos_count, _full(0, w)
                else:
                    bits = MODEL_WEIGHT_BITS * pos_count + rung_select(
                        rung, [_full(c, w) for c in live_costs],
                        _full(0, w))
                    ign = sent.to(torch.int64)
                    skip = ((executed & ~sent).to(torch.int64)
                            if budget is not None else _full(0, w))
                live_plane.emit_round(
                    salt, t, executed, bits + (setup_bits if t == 0 else 0),
                    ign, skip, carry.get("exhausted", false) & ~entry_exh)
            rows.append(row)
            bars.append(released)
            sents.append(sent)
            rungs.append(rung)

        def stack(i):
            return torch.stack([torch.stack([row[m][i] for m in range(num)])
                                for row in rows])

        return AsyncSessionResult(
            alphas=stack(1), accs=stack(2), executed=stack(3),
            valid=stack(4),
            params=tuple(stack_trees([row[m][0] for row in rows])
                         for m in range(num)),
            w_trace=stack(5), w_bar=torch.stack(bars), w=w,
            sent=torch.stack(sents), codec_idx=torch.stack(rungs),
            exhausted=carry.get("exhausted", false))

    return session_fn


def async_session(plan: SessionPlan, key, Xs: Sequence[torch.Tensor],
                  classes: torch.Tensor, *, live: bool = False,
                  source=None) -> AsyncSessionResult:
    """One stale-read async session as one fixed-shape program (``plan``'s
    scheduler an :class:`AsyncStalePlan`): its draws taken first (``key``:
    an int seed or uint32 key data; ``source``: the draw source, default
    :class:`~repro_torch.comm.draws.ChannelDraws`), then the program,
    which reads nothing back to the host.  ``live``: its round taps."""
    if not isinstance(plan.scheduler, AsyncStalePlan):
        raise ValueError("async_session lowers a plan whose scheduler is an "
                         "AsyncStalePlan")
    Xs = tuple(Xs)
    shapes = tuple(tuple(x.shape[1:]) for x in Xs)
    fn = make_async_session_fn(plan, shapes, live=live)
    draws = _draws_for(plan, key_data(key), int(classes.shape[0]), shapes,
                       classes.device, source, fleet=False)
    return fn(draws, Xs, classes)


# =================================================================== serve step
class ServeResult(NamedTuple):
    """Fixed-shape output of the serve step (with a leading [B] axis from
    :func:`serve_batch`).  ``preds`` [n] is the head's argmax; ``blocks``
    [M, n, K] the decoded blocks as shipped (slot 0 the head's own, which
    never crosses the wire); ``sent`` [M] the blocks that shipped (the
    head, budget skips and held-back blocks False); ``codec_idx`` [M] each
    one's serve-ladder rung (-1: raw or not sent); ``exhausted`` whether
    the session budget ran dry.  From them the engine books the serve
    ledger (``Protocol._replay_serve``)."""
    preds: torch.Tensor
    blocks: torch.Tensor
    sent: torch.Tensor
    codec_idx: torch.Tensor
    exhausted: torch.Tensor


def make_serve_fn(plan: SessionPlan, feature_shapes: tuple,
                  qmax_arg: bool = False, live: bool = False):
    """Lower ``plan``'s serve path for the agents' feature shapes into

        serve_fn(draws, Xs, params, alphas, valid, rem_session, rem_link,
                 deliver) -> ServeResult

    the fixed-shape twin of ``Session.predict_distributed``.  Agent j's
    [n, K] block is its alpha-weighted coded votes over its components,
    summed over rounds in the eager ``AgentEndpoint.score_block``'s order
    (a round that gave no component adds zero).  Each non-head block then
    crosses the serve channel with its draws (``draws``: the
    ``{"u", "z"}`` of :func:`repro_torch.comm.draws.serve_draws`): DP
    noise once, then under a budget the ladder walk (the serve
    controller's rung its floor), else the serve controller's rung, else
    the one serve codec; every rung's codec is evaluated and one
    selected.  The head sums what shipped and takes the argmax.
    ``rem_session`` / ``rem_link`` [M] are the remaining budget (int)
    the walk starts from, ignored without a budget; ``deliver`` [M] bool
    gates which non-head blocks cross at all (all True: a normal serve;
    ``[True, False, ...]``: admission's head-only degrade).  No host read.
    ``live`` stages one serve tap a request (:func:`repro_torch.telemetry.
    live.emit_serve`): whether it is a request (``deliver[0]``; False for
    a bucket's pad slots), its bits priced as the serve replay books them,
    the blocks sent and, under a budget, those it skipped.
    ``qmax_arg`` makes a plain :class:`~repro_torch.comm.codecs.
    QuantCodec` serve channel's range a trailing operand (``serve_fn(...,
    deliver, qmax)``, a 0-d float32 tensor): the serve axis of
    :func:`quant_sweep_run`, whose blocks quantize in one launch a agent
    for all sessions, each at its range."""
    if qmax_arg and (plan.budget is not None
                     or plan.serve_controller is not None
                     or not isinstance(plan.serve_ladder[0], QuantCodec)):
        raise ValueError("qmax_arg sweeps need a plain QuantCodec plan")
    if len(feature_shapes) != plan.num_agents:
        raise ValueError(f"{plan.num_agents} cores but "
                         f"{len(feature_shapes)} feature shapes")
    k = plan.num_classes
    cores = plan.cores
    privacy, budget = plan.privacy, plan.budget
    serve_controller = plan.serve_controller
    ladder = plan.serve_ladder

    def serve_fn(draws: dict, Xs: tuple, params: tuple,
                 alphas: torch.Tensor, valid: torch.Tensor,
                 rem_session: torch.Tensor, rem_link: torch.Tensor,
                 deliver: torch.Tensor, qmax=None) -> ServeResult:
        n = Xs[0].shape[0]
        dev = Xs[0].device
        if budget is not None:
            costs = budget.serve_costs((n, k))
            if max(costs) >= _INT32_MAX:
                raise ValueError(f"serve block costs must fit int32 (the "
                                 f"budget counters), got {max(costs)}")
            rem_s = rem_session.to(torch.int64)
            rem_l = rem_link.to(torch.int64)
        exhausted = torch.zeros((), dtype=torch.bool, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if live:
            # a shipped block's price at each rung: what _replay_serve
            # books (encoded, or raw float32 for an identity rung)
            live_costs = (budget.serve_costs((n, k)) if budget is not None
                          else tuple(c.wire_bits((n, k)) if c is not None
                                     else 32 * n * k for c in ladder))
            live_bits = live_sent = live_skip = _full(0, zero)
        total = None
        blocks, sent_l, rung_l = [], [], []
        for j, core in enumerate(cores):
            block = torch.zeros((n, k), dtype=torch.float32, device=dev)
            for t in range(alphas.shape[0]):
                pred = core.predict(tree_map(lambda x, _t=t: x[_t],
                                             params[j]), Xs[j])
                block = block + (torch.where(valid[t, j], alphas[t, j], zero)
                                 * encode_labels(pred, k))
            if j == 0:
                # the head's own block never crosses the wire
                blocks.append(block)
                sent_l.append(torch.zeros((), dtype=torch.bool, device=dev))
                rung_l.append(_full(-1, block))
                total = block
                continue
            d_j = deliver[j]
            hop = TensorHopDraws(draws["u"][j] if "u" in draws else None,
                                 draws["z"][j] if "z" in draws else None)
            if serve_controller is not None:
                # the policy reads the raw block, before any noise
                c_rung = serve_controller.rung_tensor(block)
            if budget is None and serve_controller is None:
                blk, _ = channel_apply(ladder[0], privacy, block, hop, None,
                                       qmax=qmax)
                rung = _full(0 if ladder[0] is not None else -1, block)
                sendable = d_j
            else:
                # the noise does not depend on the rung: apply it once,
                # then each rung's codec, the bits of the eager channel at
                # its rung
                noised, _ = channel_apply(None, privacy, block, hop, None)
                pairs = [channel_apply(c, None, noised, hop, None)[0]
                         for c in ladder]
                if budget is None:
                    rung, sendable = c_rung, d_j
                    blk = rung_select(rung, pairs, noised)
                else:
                    rem = torch.minimum(rem_s, rem_l[j])
                    rung = ladder_walk(costs, rem, floor=(
                        c_rung if serve_controller is not None else None))
                    sendable = (rung >= 0) & d_j
                    # a held-back block never consults the budget
                    exhausted = exhausted | (d_j & (rung < 0)
                                             & (rem_s < min(costs)))
                    blk = rung_select(rung, pairs, block)
                    cost = rung_select(rung, [_full(c, block) for c in costs],
                                       _full(0, block))
                    rem_s = rem_s - torch.where(sendable, cost,
                                                _full(0, block))
            blocks.append(blk)
            sent_l.append(sendable)
            rung_l.append(torch.where(sendable, rung, _full(-1, block)))
            total = total + torch.where(sendable, blk, zero)
            if live:
                cost = (_full(live_costs[0], block)
                        if budget is None and serve_controller is None
                        else rung_select(rung, [_full(c, block)
                                                for c in live_costs],
                                         _full(0, block)))
                live_bits = live_bits + torch.where(sendable, cost,
                                                    _full(0, block))
                live_sent = live_sent + sendable.to(torch.int64)
                if budget is not None:
                    # only a budget skips, and only blocks admission asked
                    # to deliver
                    live_skip = live_skip + (d_j & ~sendable).to(
                        torch.int64)
        if live:
            live_plane.emit_serve(Xs[0], deliver[0], live_bits, live_sent,
                                  live_skip)
        return ServeResult(preds=torch.argmax(total, dim=-1),
                           blocks=torch.stack(blocks),
                           sent=torch.stack(sent_l),
                           codec_idx=torch.stack(rung_l),
                           exhausted=exhausted)

    return serve_fn


def serve_session(plan: SessionPlan, result: SessionResult, key,
                  Xs: Sequence[torch.Tensor], *, request=None, valid=None,
                  rem_session=None, rem_link=None, deliver=None,
                  live: bool = False, source=None) -> ServeResult:
    """The serve step for one completed compiled session (``result``,
    agent-major) and one request: its draws taken first, from the
    session's key data ``key`` and the ``request`` tag (``source``: the
    draw source, default :class:`~repro_torch.comm.draws.ChannelDraws`),
    then the program.  ``valid`` overrides ``result.valid`` (e.g. masked
    by ``max_round``); ``rem_session`` / ``rem_link`` seed the budget
    counters (None: uncapped); ``deliver`` [M] bool gates the non-head
    blocks (None: all); ``live``: its serve tap."""
    Xs = tuple(Xs)
    shapes = tuple(tuple(x.shape[1:]) for x in Xs)
    n, dev = int(Xs[0].shape[0]), Xs[0].device
    num = plan.num_agents
    draws = {name: d[0] for name, d in _serve_draws_for(
        plan, [key], [request], n, dev, [source]).items()}
    return make_serve_fn(plan, shapes, live=live)(
        draws, Xs, result.params, result.alphas,
        result.valid if valid is None else valid,
        _stack_field([rem_session], (), dev)[0],
        _stack_field([rem_link], (num,), dev)[0],
        _stack_field([deliver], (num,), dev, torch.bool)[0])


def _serve_draws_for(plan: SessionPlan, keys, requests, n: int, device,
                     sources) -> dict:
    """The serve draws a plan's channel reads, for each (key, request),
    stacked."""
    if not plan.has_serve_channel:
        return {}
    stochastic = any(getattr(c, "stochastic", False)
                     for c in plan.serve_ladder if c is not None)
    return serve_draws_batch(
        [key_data(k) for k in keys], requests, plan.num_agents,
        (n, plan.num_classes), uniform=stochastic,
        normal=plan.privacy is not None, device=device, source=sources)


def serve_batch(plan: SessionPlan, slots, *, draws: dict | None = None,
                live: bool = False) -> ServeResult:
    """One serve step for a whole bucket of requests as one program
    (``torch.func.vmap`` over the slots): the continuous-batching
    primitive behind :mod:`repro_torch.serve.batcher`.  Each slot is a
    dict of what one :func:`serve_session` call takes: ``key`` (the
    session's key data), ``request`` (its tag), ``source`` (optional draw
    source), ``Xs`` (M blocks [n, p_m]), ``params`` / ``alphas`` /
    ``valid`` (the fitted session's, agent-major), ``rem_session`` /
    ``rem_link`` (int32 counters) and ``deliver`` ([M] bool).  ``draws``
    (the slots' stacked draws, already on the device) replaces the keys.
    Returns a ServeResult with a leading slot axis; slot b is what
    ``serve_session`` gives for that slot alone: the vmap never mixes
    slots, a pad slot with an all-False ``deliver`` ships nothing, and the
    block quantize is one launch for all slots (``kernels.ops``).
    ``live``: one serve tap a slot, the bucket's taps staged as one copy
    (the pad slots' dropped by the sink)."""
    slots = list(slots)
    num = plan.num_agents
    Xs = tuple(torch.stack([s["Xs"][m] for s in slots]) for m in range(num))
    n, dev = int(Xs[0].shape[1]), Xs[0].device
    if draws is None:
        draws = _serve_draws_for(plan, [s["key"] for s in slots],
                                 [s.get("request") for s in slots], n, dev,
                                 [s.get("source") for s in slots])
    fn = make_serve_fn(plan, tuple(tuple(x.shape[2:]) for x in Xs),
                       live=live)
    return torch.func.vmap(fn)(
        draws, Xs, stack_trees([s["params"] for s in slots]),
        torch.stack([s["alphas"] for s in slots]),
        torch.stack([s["valid"] for s in slots]),
        _stack_field([s["rem_session"] for s in slots], (), dev),
        _stack_field([s["rem_link"] for s in slots], (num,), dev),
        _stack_field([s["deliver"] for s in slots], (num,), dev,
                     torch.bool))


def _stack_field(values: list, shape: tuple, device,
                 dtype=torch.int32) -> torch.Tensor:
    """A budget counter (int32; None: uncapped, ints capped at int32 max)
    or a ``deliver`` mask (bool; None: every block) of each slot, stacked
    on ``device``: tensors by a stack there, host values in one array and
    one copy."""
    if all(isinstance(v, torch.Tensor) for v in values):
        return torch.stack([v.to(device=device, dtype=dtype)
                            for v in values])
    if dtype == torch.bool:
        host = np.stack([np.broadcast_to(np.asarray(
            True if v is None else v, dtype=bool), shape) for v in values])
        return torch.as_tensor(host, device=device)
    host = np.stack([np.broadcast_to(np.minimum(np.asarray(
        _INT32_MAX if v is None else v, dtype=np.int64), _INT32_MAX), shape)
        for v in values]).astype(np.int32)
    return torch.as_tensor(host, device=device)


# ================================================================= codec sweep
def _host_qmaxes(qmaxes) -> np.ndarray:
    """The sweep's ranges as host float32, range-checked while they are
    host values (the kernels never read a range back): each in [1, 127],
    the int8 carrier's."""
    if isinstance(qmaxes, torch.Tensor) and qmaxes.device.type != "cpu":
        raise TypeError("quant_sweep_run takes its ranges as host values "
                        "(a list or a CPU array), not a device tensor")
    qm = np.asarray(qmaxes, dtype=np.float32).reshape(-1)
    bad = [float(q) for q in qm if not 1.0 <= q <= 127.0]
    if bad:
        raise ValueError(f"qmax must lie in [1, 127] (an int8 carrier), "
                         f"got {bad}")
    return qm


def quant_sweep_run(plan: SessionPlan, keys, Xs: Sequence[torch.Tensor],
                    classes: torch.Tensor, qmaxes, serve_Xs=None, *,
                    source=None):
    """A codec sweep as one program: session s runs with key ``keys[s]``
    and the plan's :class:`~repro_torch.comm.codecs.QuantCodec` at range
    ``[-qmaxes[s], qmaxes[s]]`` (e.g. ``[127, 31, 7]``, an int8/int6/int4
    frontier; equal keys isolate the codec axis).  ``torch.func.vmap``
    over the session function with the range an operand, so each hop's
    quantize is one launch for all S sessions
    (``quantize.quantize_dequant_rows`` with the ranges a tensor).  ``qmaxes`` are host values,
    range-checked here; wire bits a session follow from
    :func:`repro_torch.comm.codecs.quant_bits_per_element`.  With
    ``serve_Xs`` (each agent's serve-time block) each session also runs
    the serve step at its range, with its key's untagged serve draws (as
    :func:`serve_session` draws them), and the call returns
    ``(SessionResult, ServeResult)``, both with a leading sweep axis.
    ``source``: the draw source, or one a key.  Row s equals
    :func:`compiled_session` (and :func:`serve_session`) of a static plan
    whose codec has range ``qmaxes[s]``, bit for bit: the kernel forms the
    reciprocal the static path passes."""
    qm = _host_qmaxes(qmaxes)
    keys = [key_data(k) for k in keys]
    if len(keys) != qm.shape[0]:
        raise ValueError(f"{len(keys)} keys for {qm.shape[0]} ranges")
    Xs = tuple(Xs)
    shapes = tuple(tuple(x.shape[1:]) for x in Xs)
    n, dev = int(classes.shape[0]), classes.device
    fn = make_session_fn(plan, shapes, qmax_arg=True)
    draws = _draws_for(plan, keys, n, shapes, dev, source, fleet=True)
    qmax = torch.as_tensor(qm, device=dev)
    if serve_Xs is None:
        return torch.func.vmap(fn, in_dims=(0, None, None, 0))(
            draws, Xs, classes, qmax)
    serve_Xs = tuple(serve_Xs)
    num = plan.num_agents
    srv = make_serve_fn(plan, tuple(tuple(x.shape[1:]) for x in serve_Xs),
                        qmax_arg=True)
    sources = (source if isinstance(source, (list, tuple))
               else [source] * len(keys))
    sdraws = _serve_draws_for(plan, keys, [None] * len(keys),
                              int(serve_Xs[0].shape[0]), dev, sources)
    rem_s = _stack_field([None], (), dev)[0]
    rem_l = _stack_field([None], (num,), dev)[0]
    deliver = _stack_field([None], (num,), dev, torch.bool)[0]

    def run_one(d, sd, Xs, classes, qmax, sXs):
        res = fn(d, Xs, classes, qmax)
        return res, srv(sd, sXs, res.params, res.alphas, res.valid, rem_s,
                        rem_l, deliver, qmax)

    return torch.func.vmap(run_one, in_dims=(0, 0, None, None, 0, None))(
        draws, sdraws, Xs, classes, qmax, serve_Xs)


# =============================================================== control sweep
def control_sweep_run(plan: SessionPlan, keys, Xs: Sequence[torch.Tensor],
                      classes: torch.Tensor, *, cuts=None, betas=None,
                      session_bits=None, link_bits=None, live: bool = False,
                      source=None) -> SessionResult:
    """A control-plane sweep as one program: config s runs with key
    ``keys[s]`` under its controller cuts (``cuts`` [S, R-1]) and EMA
    ``betas`` [S] and its budget caps (``session_bits`` / ``link_bits``,
    S entries each, None for uncapped, lowered as the int32 sentinel).
    An axis left None takes the plan's static values.  One session
    function is built (``TRACE_COUNTS['control_sweep']`` counts it, in
    :func:`make_session_fn`) and
    vmapped over the configs with ``torch.func.vmap``, as
    :func:`fleet_run` does.  Returns a :class:`SessionResult` with a
    leading config axis; row s equals :func:`compiled_session` of the
    static plan with config s's values bit for bit.  ``live``: one round
    tap a config and round (the tap's vmap rule stages a round's S taps
    as one copy).  ``source``: the draw source, or one a key."""
    if plan.budget is None and plan.controller is None:
        raise ValueError("control_sweep_run sweeps controller thresholds "
                         "and budget caps; the plan has neither")
    keys = [key_data(k) for k in keys]
    S = len(keys)
    Xs = tuple(Xs)
    shapes = tuple(tuple(x.shape[1:]) for x in Xs)
    n, dev = int(classes.shape[0]), classes.device
    ctrl = plan.controller
    if cuts is None:
        base = ctrl.thresholds if ctrl is not None else ()
        cuts = np.tile(np.asarray(base, np.float32).reshape(1, -1), (S, 1))
    if betas is None:
        betas = [ctrl.beta if ctrl is not None else 0.0] * S
    budget = plan.budget

    def cap_axis(vals, static):
        vals = [static] * S if vals is None else list(vals)
        return torch.as_tensor(np.asarray(
            [_INT32_MAX if v is None else min(int(v), _INT32_MAX)
             for v in vals], dtype=np.int64), device=dev)

    sb = cap_axis(session_bits, budget.session_bits if budget else None)
    lb = cap_axis(link_bits, budget.link_bits if budget else None)
    cuts_t = torch.as_tensor(np.asarray(cuts, np.float32).reshape(S, -1),
                             device=dev)
    betas_t = torch.as_tensor(np.asarray(betas, np.float32).reshape(S),
                              device=dev)
    fn = make_session_fn(plan, shapes, control_arg=True, live=live)
    draws = _draws_for(plan, keys, n, shapes, dev, source, fleet=True)
    return torch.func.vmap(fn, in_dims=(0, None, None, 0, 0, 0, 0))(
        draws, Xs, classes, cuts_t, betas_t, sb, lb)


# ============================================================= host extraction
def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def agent_major_result(result: SessionResult) -> SessionResult:
    """Re-collect a slot-major result to agent-major: under a permuting
    scheduler slot j of round t holds agent ``order[t, j]``; per-agent
    consumers (the serve paths) index agents positionally.  The params are
    agent-major already under a scheduler.  Identity plans come back as
    they are."""
    order = _host(result.order)
    T, M = order.shape
    if np.array_equal(order, np.tile(np.arange(M), (T, 1))):
        return result
    inv = torch.as_tensor(np.argsort(order, axis=1),
                          device=result.alphas.device)

    def collect(a):
        return torch.gather(a, 1, inv.reshape(T, M, *([1] * (a.dim() - 2)))
                            .expand(a.shape))

    return result._replace(
        alphas=collect(result.alphas), accs=collect(result.accs),
        executed=collect(result.executed), valid=collect(result.valid),
        w_trace=collect(result.w_trace),
        sent=collect(result.sent), codec_idx=collect(result.codec_idx),
        order=torch.arange(M, device=result.order.device).repeat(T, 1))


def fitted_from_result(plan: SessionPlan, result: SessionResult,
                       learners: Sequence):
    """The eager engine's result from a compiled run: the components
    (valid slots in visit order, agent ids from ``result.order``), the
    round history and a :class:`~repro_torch.core.engine.FittedASCII`, as
    ``Protocol.fit`` returns them on the eager path."""
    from repro_torch.core.engine import Component, FittedASCII
    alphas, accs = _host(result.alphas), _host(result.accs)
    executed, valid = _host(result.executed), _host(result.valid)
    order = _host(result.order)
    components, history = [], []
    for t in range(plan.max_rounds):
        if not executed[t].any():
            break                        # the eager loop stopped before t
        rec = {"round": t, "alphas": [], "accs": []}
        for j in range(plan.num_agents):
            if not executed[t, j]:
                break                    # the alpha <= 0 stop, mid-round
            rec["alphas"].append(float(alphas[t, j]))
            rec["accs"].append(float(accs[t, j]))
            if valid[t, j]:
                agent = int(order[t, j])
                params = tree_map(lambda x, _t=t: x[_t], result.params[
                    j if plan.scheduler is None else agent])
                components.append(Component(agent, t, float(alphas[t, j]),
                                            params))
        history.append(rec)
    return FittedASCII(components, list(learners), plan.num_classes, history)


def fitted_from_async_result(plan: SessionPlan, result: AsyncSessionResult,
                             learners: Sequence):
    """The eager engine's result from a compiled async run, as the eager
    ``_step_stale`` session's ``fitted()`` gives it: every executed round
    records all M alphas and accs, and its components are the positive
    alphas in agent order."""
    from repro_torch.core.engine import Component, FittedASCII
    alphas, accs = _host(result.alphas), _host(result.accs)
    executed, valid = _host(result.executed), _host(result.valid)
    components, history = [], []
    for t in range(plan.max_rounds):
        if not executed[t].any():
            break                        # the eager loop stopped before t
        history.append({"round": t,
                        "alphas": [float(a) for a in alphas[t]],
                        "accs": [float(a) for a in accs[t]]})
        for m in range(plan.num_agents):
            if valid[t, m]:
                components.append(Component(
                    m, t, float(alphas[t, m]),
                    tree_map(lambda x, _t=t: x[_t], result.params[m])))
    return FittedASCII(components, list(learners), plan.num_classes, history)

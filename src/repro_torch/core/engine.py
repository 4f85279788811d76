"""Agent-session engine for the ASCII interchange protocol (eager, main path).

Counterpart of ``repro/core/engine.py``, its eager subset: endpoints
exchange typed messages through a pluggable Transport, the round order is a
pluggable Scheduler, and the protocol state is an explicit checkpointable
SessionState.  Every transport optionally carries a wire channel
(``repro_torch.comm``): a codec, whose encoded size the ledger books and
whose decoded tensor the protocol continues from; a Gaussian mechanism with
its accountant; a serve codec for prediction-time score blocks; on
:class:`~repro_torch.comm.budget.BudgetedTransport`, a bit budget; and the
control plane (``repro_torch.control``): an adaptive controller that picks
the codec's rung hop by hop, a serve controller that picks it block by
block, and the budget-aware scheduler.  The async variant
(:class:`AsyncStaleScheduler`) runs the stale-read round with its barrier
merge and, under a channel, one release a round (``barrier_release``).
``Protocol(backend="compiled")`` runs the whole session as one
fixed-shape program with no read to the host (:mod:`repro_torch.core.
compiled`) and books the ledger afterwards by replaying the result
(:meth:`Protocol._replay_traffic`), bit for bit the eager run's; it serves
through the compiled serve step and replays the serve ledger
(:meth:`Protocol._replay_serve`).  An async-stale run lowers through the
barrier's own program (``compiled.async_session``) and books the async
ledger (:meth:`Protocol._replay_traffic_async`).

The round rule is a :class:`ProtocolVariant`: :class:`ASCIIVariant`, or
FedAvg and Assisted Learning (:mod:`repro_torch.scenarios.protocols`),
whose hops cross the same channel through :meth:`Transport.ship`
(:class:`GradientMsg`, :class:`ResidualMsg`).  A scenario
(:mod:`repro_torch.scenarios.scenario`) filters each round's order by
its participation mask, masks the fit weights to non-IID shards and lags
the async reads by a clock skew.  ``telemetry=`` (a
:class:`repro_torch.telemetry.Telemetry`) observes a run as the
reference's does: ``session`` -> ``round`` -> ``hop`` spans on the eager
path, ``session`` and ``replay`` (and ``serve``) on the compiled one, the
ledger's counters at the transport's choke points, and the live plane's
round and serve taps; it changes no value and no kernel launch.  The
mesh ring (``MeshRingTransport(mesh=).ring_step``) runs a round of hops
over a ``torch.distributed`` mesh (``core.collectives``).

One rule differs from the reference, and it is deliberate: every standard
hop (``Transport._execute_update``) goes through
``kernels.ops.ignorance_update``, the CUDA kernel for CUDA tensors and its
plain version for CPU tensors, on every transport and at any n.  The
reference runs its Pallas kernel on ``MeshRingTransport`` only and when n
tiles its grid; the function is the same within float32 rounding.

The session's PRNG key is carried as opaque uint32 key data (the
reference's ``jax.random.key_data``), saved and restored with the state,
and never advanced.  Every random draw comes from a
:class:`~repro_torch.comm.draws.ChannelDraws` source, indexed by the key
data and coordinates: a learner's fit draws and a hop's channel draws by
the hop's (round, position), an async barrier's by its round, a serve
block's by its (agent, request).  A resumed session draws what the
uninterrupted one would, and a session on the card what it draws on the
CPU.  Where the reference splits its key once a hop and hands the subkey
to the learner, the port hands the learner the fit's draws in the same
``key`` slot of ``Learner.fit``.

Quickstart::

    endpoints = [AgentEndpoint(0, DecisionTree(depth=3), X_a),
                 AgentEndpoint(1, DecisionTree(depth=3), X_b)]
    engine = Protocol(SessionConfig(num_classes=10, max_rounds=6),
                      transport=MeteredTransport())
    session = engine.start(0, endpoints, classes)
    session.run()
    preds = session.fitted().predict([Xte_a, Xte_b])
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.comm.codecs import channel_apply
from repro_torch.comm.draws import ChannelDraws
from repro_torch.core import scores
from repro_torch.core.encoding import encode_labels
from repro_torch.core.transport import TransportLog
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.learners.base import Learner
from repro_torch.telemetry.live import installed as live_installed
from repro_torch.telemetry.spans import fence_of, span_of

Params = Any

VARIANTS = ("ascii", "simple", "random", "async")


def key_data(key) -> np.ndarray:
    """Opaque uint32 key data: an int seed becomes the data of the
    reference's ``jax.random.key(seed)``, i.e. ``[0, seed]``; an array of
    key data is taken as it is."""
    if isinstance(key, (int, np.integer)):
        return np.array([0, int(key) & 0xFFFFFFFF], dtype=np.uint32)
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    return np.asarray(key).astype(np.uint32)


def shard_fit_weight(w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Fit weights ``w`` masked to one agent's non-IID shard and
    renormalized, the sum taken in float64 and rounded (the same on the
    card and the CPU), floored at 1e-12 as the reference's."""
    wm = w * mask
    total = torch.sum(wm.to(torch.float64)).to(torch.float32)
    return wm / torch.clamp(total, min=1e-12)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


# ===================================================================== messages
@dataclass(frozen=True)
class Message:
    """Base class for everything that crosses an agent boundary; its size
    lets transports meter without reading the payload.  A message that went
    through a wire codec carries its *encoded* size in ``wire_bits``, and
    ``bits`` prefers it: the ledger prices what crossed the wire."""
    src: str
    dst: str

    kind = "message"
    bits_per_element = 32
    # a class attribute, not a field: subclasses with an encoded payload
    # redeclare it as their trailing field
    wire_bits = None

    @property
    def num_elements(self) -> int:
        return 0

    @property
    def bits(self) -> int:
        if self.wire_bits is not None:
            return self.wire_bits
        return self.num_elements * self.bits_per_element


@dataclass(frozen=True)
class IgnoranceMsg(Message):
    """The length-n ignorance score shipped on every interchange hop: the
    decoded payload ``w`` and, under a codec, its encoded ``wire_bits``."""
    w: torch.Tensor = None
    wire_bits: int | None = None

    kind = "ignorance"

    @property
    def num_elements(self) -> int:
        return int(self.w.numel())


@dataclass(frozen=True)
class ModelWeightMsg(Message):
    """The scalar model weight alpha accompanying each hop."""
    alpha: float = 0.0

    kind = "model_weight"

    @property
    def num_elements(self) -> int:
        return 1


@dataclass(frozen=True)
class ScoreBlockMsg(Message):
    """An [n, K] coded score block: an agent's alpha-weighted votes, the
    prediction-time traffic of Algorithm 1 line 12.  ``scores`` is the
    decoded block the head sums; ``wire_bits`` its encoded size under a
    serve codec."""
    scores: torch.Tensor = None
    wire_bits: int | None = None

    kind = "score_block"

    @property
    def num_elements(self) -> int:
        return int(self.scores.numel())


@dataclass(frozen=True)
class GradientMsg(Message):
    """A FedAvg flat model delta (client -> server uplink), or the server's
    raw broadcast of the new global model.  ``delta`` is the decoded
    payload the server averages; ``wire_bits`` its encoded size under a
    codec."""
    delta: torch.Tensor = None
    wire_bits: int | None = None

    kind = "gradient"

    @property
    def num_elements(self) -> int:
        return int(np.prod(tuple(self.delta.shape), dtype=np.int64))


@dataclass(frozen=True)
class ResidualMsg(Message):
    """An Assisted-Learning [n, K] residual block passed along the ring:
    what remains of the label signal after the sender's fit.  ``residual``
    is the decoded payload the next agent fits; ``wire_bits`` its encoded
    size under a codec."""
    residual: torch.Tensor = None
    wire_bits: int | None = None

    kind = "residual"

    @property
    def num_elements(self) -> int:
        return int(np.prod(tuple(self.residual.shape), dtype=np.int64))


@dataclass(frozen=True)
class LabelsMsg(Message):
    """One-time setup: the head agent shares the numeric labels."""
    num_samples: int = 0

    kind = "labels"

    @property
    def num_elements(self) -> int:
        return self.num_samples


@dataclass(frozen=True)
class SampleIdsMsg(Message):
    """One-time setup: collation IDs aligning rows across agents."""
    num_samples: int = 0

    kind = "sample_ids"

    @property
    def num_elements(self) -> int:
        return self.num_samples


# =================================================================== transports
class Transport(abc.ABC):
    """How messages move between endpoints and where the interchange update
    runs.  ``bind`` gives the transport the endpoint registry, ``send``
    routes a message into the destination inbox (``_on_send`` is the
    metering hook), and ``interchange`` executes one hop of eqs. (10)/(12).

    The optional wire channel: ``codec`` (the outgoing score is encoded,
    priced at its encoded size, and the protocol continues from the decoded
    tensor), ``privacy`` (a Gaussian mechanism on the outgoing vector, each
    release tallied per agent in ``accountant``), and ``serve_codec`` (the
    prediction-time score blocks' codec; ``codec`` when unset).  A
    ``controller`` (:class:`~repro_torch.control.adaptive.
    AdaptiveController`) replaces a fixed codec: each hop ships at the rung
    its EMA (``ctrl_state``) picks.  A ``serve_controller`` replaces a
    fixed serve codec: each block ships at the rung its statistic picks.
    """

    def __init__(self, codec=None, privacy=None, serve_codec=None,
                 controller=None, accountant=None,
                 serve_controller=None) -> None:
        self._endpoints: dict[str, AgentEndpoint] = {}
        if controller is not None:
            if codec is not None:
                raise ValueError(
                    "an adaptive controller drives codec choice through its "
                    "ladder; drop codec= (or pass the codec as a one-rung "
                    "controller ladder)")
            codec = controller.ladder[0]
        if serve_controller is not None and serve_codec is not None:
            raise ValueError(
                "a serve controller picks the serve rung per score block "
                "through its ladder; drop serve_codec=")
        self.codec = codec
        self.privacy = privacy
        self.serve_codec = serve_codec
        self.controller = controller
        self.ctrl_state = (None if controller is None
                           else controller.init_state())
        self.serve_controller = serve_controller
        if accountant is not None and privacy is None:
            raise ValueError("an accountant without a privacy mechanism has "
                             "nothing to account; pass privacy= too")
        self.accountant = None
        if privacy is not None:
            if accountant is None:
                from repro_torch.comm.privacy import PrivacyAccountant
                accountant = PrivacyAccountant()
            self.accountant = accountant

    @property
    def has_channel(self) -> bool:
        return self.codec is not None or self.privacy is not None

    @property
    def effective_serve_codec(self):
        """The one serve codec, if there is one: ``serve_codec``, else
        ``codec`` unless a controller drives it (the training controller's
        statistic reads ignorance vectors, so its serve traffic ships raw,
        as the reference's) or a serve controller picks it per block."""
        if self.serve_codec is not None:
            return self.serve_codec
        if self.serve_controller is not None or self.controller is not None:
            return None
        return self.codec

    @property
    def has_serve_channel(self) -> bool:
        return (self.effective_serve_codec is not None
                or self.serve_controller is not None
                or self.privacy is not None)

    def bind(self, endpoints: Sequence["AgentEndpoint"]) -> None:
        self._endpoints = {ep.name: ep for ep in endpoints}

    def send(self, msg: Message) -> None:
        self._on_send(msg)
        ep = self._endpoints.get(msg.dst)
        if ep is not None:
            ep.receive(msg)

    def _on_send(self, msg: Message) -> None:  # metering hook
        pass

    def _execute_update(self, w: torch.Tensor, r: torch.Tensor,
                        alpha: torch.Tensor, reweight: Callable,
                        standard: bool) -> torch.Tensor:
        """A standard hop runs the ignorance kernel (plain version on the
        CPU); the exact-reweight surrogate has no kernel in either package
        and stays plain torch."""
        if not standard:
            return reweight(w, r, alpha)
        return ops.ignorance_update(w, r, alpha.to(w.dtype))

    def _controller_rung(self, w_prev: torch.Tensor,
                         w_out: torch.Tensor) -> int:
        """One controller step: observe the hop (the receiver's vector and
        the outgoing one), advance the EMA, return the rung."""
        rung, self.ctrl_state = self.controller.step(w_prev, w_out,
                                                     self.ctrl_state)
        return rung

    def _admit(self, src: "AgentEndpoint", dst: "AgentEndpoint",
               w: torch.Tensor, rung: int) -> bool:
        """Set the hop's codec from ``rung`` (the controller's, 0 without
        one); False drops the hop.  A budgeted transport walks its ladder
        from ``rung`` instead (the rung a floor)."""
        if self.controller is not None:
            self.codec = self.controller.ladder[rung]
        return True

    def interchange(self, src: "AgentEndpoint", dst: "AgentEndpoint",
                    w: torch.Tensor, r: torch.Tensor, alpha: torch.Tensor,
                    reweight: Callable, standard: bool = True, *,
                    draws=None, codec_state=None):
        """One hop: w' = reweight(w, r, alpha), through the wire channel
        (DP noise, then the codec), shipped src -> dst with its model
        weight.  Returns ``(w_received, codec_state)``: what the receiver
        decodes and the link's updated codec state (the top-k residual;
        None for stateless codecs); a dropped hop returns ``(w,
        codec_state)``, the receiver keeping its stale score.  ``draws``
        are the hop's channel draws
        (:class:`~repro_torch.comm.draws.HopDraws`).  A controller observes
        the outgoing vector, so with one the update runs before
        :meth:`_admit`, else only once the hop is admitted."""
        w_next, rung = None, 0
        if self.controller is not None:
            w_next = self._execute_update(w, r, alpha, reweight, standard)
            rung = self._controller_rung(w, w_next)
        if not self._admit(src, dst, w, rung):
            return w, codec_state
        if w_next is None:
            w_next = self._execute_update(w, r, alpha, reweight, standard)
        wire_bits = None
        if self.has_channel:
            n = int(w.shape[0])
            if (self.codec is not None and self.codec.stateful
                    and codec_state is None):
                codec_state = self.codec.init_state(n, w.device)
            w_next, codec_state = channel_apply(self.codec, self.privacy,
                                                w_next, draws, codec_state)
            if self.privacy is not None:
                self.accountant.record(src.name)
            if self.codec is not None:
                wire_bits = self.codec.wire_bits(n)
        self.send(IgnoranceMsg(src.name, dst.name, w_next,
                               wire_bits=wire_bits))
        self.send(ModelWeightMsg(src.name, dst.name, float(alpha)))
        return w_next, codec_state

    def serve_block(self, src: "AgentEndpoint", dst: "AgentEndpoint",
                    block: torch.Tensor, *, draws=None):
        """One prediction-time hop: ship ``src``'s [n, K] score block to
        ``dst`` (the head agent) through the serve channel (DP noise, then
        the serve codec), priced at its encoded size.  Returns the decoded
        block the head sums, or None when a budgeted transport drops it.
        A stateful codec runs with a fresh residual: serve calls are
        independent.  A serve controller picks the block's rung from the
        raw block (before any noise)."""
        codec = self.effective_serve_codec
        if self.serve_controller is not None and codec is None:
            codec = self.serve_controller.ladder[
                self.serve_controller.rung_for(block)]
        wire_bits = None
        if codec is not None or self.privacy is not None:
            block, _ = channel_apply(codec, self.privacy, block, draws, None)
            if self.privacy is not None:
                self.accountant.record(src.name)
            if codec is not None:
                wire_bits = int(codec.wire_bits(tuple(block.shape)))
        self.send(ScoreBlockMsg(src.name, dst.name, block,
                                wire_bits=wire_bits))
        return block

    def ship(self, src: "AgentEndpoint", dst: "AgentEndpoint",
             payload: torch.Tensor, wrap, *, draws=None):
        """One protocol-variant hop: ship ``payload`` (a FedAvg delta, an
        Assisted-Learning residual block) src -> dst through the wire
        channel (DP noise, then the codec), priced at its encoded size and
        wrapped in ``wrap`` (:class:`GradientMsg` / :class:`ResidualMsg`).
        Returns the decoded payload the receiver computes with, or None
        when a budgeted transport drops the hop (the receiver keeps its
        stale state).  ``draws`` are the hop's channel draws.  A stateful
        codec runs with a fresh residual: variant traffic keeps no
        per-link state."""
        wire_bits = None
        if self.has_channel:
            payload, _ = channel_apply(self.codec, self.privacy, payload,
                                       draws, None)
            if self.privacy is not None:
                self.accountant.record(src.name)
            if self.codec is not None:
                wire_bits = int(self.codec.wire_bits(tuple(payload.shape)))
        self.send(wrap(src.name, dst.name, payload, wire_bits=wire_bits))
        return payload

    def barrier_release(self, head: "AgentEndpoint", w_bar: torch.Tensor,
                        *, draws=None, codec_state=None):
        """One async barrier's release: the merged, renormalized score
        crosses the wire channel once a round (DP noise, then the codec),
        priced at its encoded size, and goes to the round's head as one
        IgnoranceMsg from the sender ``"barrier"``.  Returns ``(w_released,
        codec_state)``; a budgeted transport may skip the release
        (``(None, codec_state)``).  ``draws`` are the barrier's channel
        draws, ``codec_state`` the barrier link's top-k residual."""
        n = int(w_bar.shape[0])
        if (self.codec is not None and self.codec.stateful
                and codec_state is None):
            codec_state = self.codec.init_state(n, w_bar.device)
        w_rel, codec_state = channel_apply(self.codec, self.privacy, w_bar,
                                           draws, codec_state)
        if self.privacy is not None:
            self.accountant.record("barrier")
        wire_bits = (self.codec.wire_bits(n) if self.codec is not None
                     else None)
        self.send(IgnoranceMsg("barrier", head.name, w_rel,
                               wire_bits=wire_bits))
        return w_rel, codec_state


class InProcessTransport(Transport):
    """Direct in-memory delivery; the plain single-host path."""


class MeteredTransport(Transport):
    """In-process delivery that books every bit into a
    :class:`~repro_torch.core.transport.TransportLog` (Fig. 4).  With a
    codec attached the ledger books *encoded* bits."""

    def __init__(self, log: TransportLog | None = None, codec=None,
                 privacy=None, serve_codec=None, controller=None,
                 accountant=None, serve_controller=None) -> None:
        super().__init__(codec=codec, privacy=privacy,
                         serve_codec=serve_codec, controller=controller,
                         accountant=accountant,
                         serve_controller=serve_controller)
        self.log = log if log is not None else TransportLog()

    def _on_send(self, msg: Message) -> None:
        if msg.wire_bits is not None:
            # a budgeted subclass arms _pending_rung in record_spend; the
            # wire-priced booking that follows stamps it onto its entry
            rung = getattr(self, "_pending_rung", None)
            self.log.send_bits(msg.src, msg.dst, msg.kind, msg.wire_bits,
                               rung=rung)
            if rung is not None:
                self._pending_rung = None
        else:
            self.log.send(msg.src, msg.dst, msg.kind, msg.num_elements,
                          msg.bits_per_element)

    @property
    def total_bits(self) -> int:
        return self.log.total_bits

    def bits_by_kind(self) -> dict:
        return self.log.bits_by_kind()


class MeshRingTransport(Transport):
    """Device-resident interchange.  Each hop runs through the ignorance
    kernel, as on every transport of the port, with or without a mesh;
    given a mesh (:class:`repro_torch.sharding.context.Mesh`) with an
    ``agent`` axis, :meth:`ring_step` runs a whole round of hops as one
    neighbour exchange over it (``core.collectives``)."""

    def __init__(self, mesh=None, *, agent_axis: str = "agent",
                 data_axis: str = "data", **channel) -> None:
        super().__init__(**channel)
        self.mesh = mesh
        self.agent_axis = agent_axis
        self.data_axis = data_axis
        self._ring = None

    def ring_step(self, w_stack: torch.Tensor, r_stack: torch.Tensor,
                  alphas: torch.Tensor) -> torch.Tensor:
        """All-lanes ring hop on the mesh: agent m + 1 receives agent m's
        updated score.  Shapes [M, n], [M, n], [M]; full tensors that
        every rank passes alike, and the full result on every rank."""
        if self.mesh is None:
            raise ValueError("ring_step needs a mesh with an agent axis")
        if self._ring is None:
            from repro_torch.core.collectives import make_ring_interchange
            self._ring = make_ring_interchange(
                self.mesh, agent_axis=self.agent_axis,
                data_axis=self.data_axis)
        return self._ring(w_stack, r_stack, alphas)


# =================================================================== schedulers
class Scheduler(abc.ABC):
    """Round-order policy: which active agents act, in what order.
    ``stale`` selects the async execution model (every agent reads the
    same round-t score; the updates merge at the round's barrier)."""

    stale = False

    def reset(self) -> None:
        """Called at session start; clears any per-run RNG state."""

    def bind_transport(self, transport: "Transport") -> None:
        """The session hands its transport to schedulers that order by
        live channel state; stateless schedulers ignore it."""

    def observe(self, agent_id: int, acc: float) -> None:
        """The session reports each agent's weighted accuracy after its
        fit; stateless schedulers ignore it."""

    @abc.abstractmethod
    def round_order(self, round_idx: int, active: list[int]) -> list[int]:
        """Agent ids (a permutation of ``active``) for round ``round_idx``."""

    def skip_to(self, order_sizes: Sequence[int]) -> None:
        """Fast-forward RNG state past already-executed rounds (resume);
        ``order_sizes`` holds each completed round's active-agent count."""
        for t, size in enumerate(order_sizes):
            self.round_order(t, list(range(size)))


class SequentialScheduler(Scheduler):
    """The paper's chain 1 -> 2 -> ... -> M, every round."""

    def round_order(self, round_idx: int, active: list[int]) -> list[int]:
        return list(active)


class RandomScheduler(Scheduler):
    """ASCII-Random: a fresh random agent order each round (numpy's
    generator, so the orders equal the reference's)."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def reset(self) -> None:
        self._rng = np.random.default_rng(self.seed)

    def round_order(self, round_idx: int, active: list[int]) -> list[int]:
        perm = self._rng.permutation(len(active))
        return [active[i] for i in perm]


class AsyncStaleScheduler(SequentialScheduler):
    """Beyond-paper asynchronous rounds: every agent fits against the same
    stale round-t score, and the positive updates merge multiplicatively,
    damped by 1/M, at the round's barrier (``Session._step_stale``)."""

    stale = True


# ======================================================================= agents
@dataclass
class AgentEndpoint:
    """One protocol participant: a private learner plus its local feature
    block.  Raw features never leave the endpoint; only messages do.
    ``active`` gates participation round by round (dropout)."""

    agent_id: int
    learner: Learner
    X: torch.Tensor
    name: str = ""
    active: bool = True
    inbox: list[Message] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.name:
            self.name = f"agent{self.agent_id}"

    def receive(self, msg: Message) -> None:
        # keep only the freshest message per kind
        self.inbox = [m for m in self.inbox if m.kind != msg.kind]
        self.inbox.append(msg)

    def fit_local(self, key, classes: torch.Tensor, w: torch.Tensor,
                  num_classes: int) -> Params:
        return self.learner.fit(key, self.X, classes, w, num_classes)

    def reward(self, params: Params, classes: torch.Tensor) -> torch.Tensor:
        return self.learner.reward(params, self.X, classes)

    def score_block(self, components: Sequence["Component"], num_classes: int,
                    X: torch.Tensor | None = None,
                    max_round: int | None = None) -> torch.Tensor:
        """This agent's [n, K] alpha-weighted coded votes over its own
        components (the prediction-time ScoreBlockMsg payload)."""
        X = self.X if X is None else X
        total = torch.zeros((X.shape[0], num_classes), dtype=torch.float32,
                            device=self.learner.torch_device)
        for comp in components:
            if comp.agent != self.agent_id:
                continue
            if max_round is not None and comp.round > max_round:
                continue
            total = total + _component_score(comp, self.learner, X,
                                             num_classes)
        return total


# ================================================================ fitted result
@dataclass
class Component:
    """One boosting component: (agent, round, alpha, fitted params)."""
    agent: int
    round: int
    alpha: float
    params: Params


def _component_score(comp: Component, learner: Learner, X: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """One component's [n, K] contribution: alpha * coded votes."""
    pred = learner.predict(comp.params, X)
    return comp.alpha * encode_labels(pred, num_classes)


@dataclass
class FittedASCII:
    """The trained ensemble: Algorithm 1's output, usable for prediction."""
    components: list[Component]
    learners: Sequence[Learner]
    num_classes: int
    history: list[dict] = field(default_factory=list)

    def decision_scores(self, Xs: Sequence[torch.Tensor],
                        max_round: int | None = None) -> torch.Tensor:
        """Line 12 of Algorithm 1: sum_t sum_m alpha * g (coded scores),
        summed in component order (not grouped per agent): the float
        addition order, and so the predictions, match the reference."""
        n = Xs[0].shape[0]
        total = torch.zeros((n, self.num_classes), dtype=torch.float32,
                            device=self.learners[0].torch_device)
        for comp in self.components:
            if max_round is not None and comp.round > max_round:
                continue
            total = total + _component_score(comp, self.learners[comp.agent],
                                             Xs[comp.agent], self.num_classes)
        return total

    def predict(self, Xs: Sequence[torch.Tensor],
                max_round: int | None = None) -> torch.Tensor:
        return torch.argmax(self.decision_scores(Xs, max_round), dim=-1)

    @property
    def num_rounds(self) -> int:
        return max((c.round for c in self.components), default=-1) + 1


# ============================================================ protocol variants
class ProtocolVariant(abc.ABC):
    """The round rule of one decentralized-learning protocol.  The session
    loop (scheduling, churn filtering, budget exhaustion, the CV stop,
    checkpoints) is the engine's; a variant supplies one round and how its
    trained model predicts.  ASCII is the built-in variant; FedAvg and
    Assisted Learning (:mod:`repro_torch.scenarios.protocols`) ship their
    traffic through the same transports, codecs, budgets and accountants:
    one wire, comparable ledgers."""

    name = "variant"

    def bind(self, session: "Session") -> None:
        """Session-start hook (fresh starts and resumes): check the roster
        and initialize ``session.state.proto`` when it is missing."""

    @abc.abstractmethod
    def run_round(self, session: "Session", order: list[int],
                  rec: dict) -> bool:
        """One round over the churn-filtered agent ``order``, recorded into
        ``rec``; True when the protocol's own stop fired."""

    @abc.abstractmethod
    def fitted(self, session: "Session"):
        """The trained, predict-capable result of this session."""

    def fit_compiled(self, protocol: "Protocol", key, endpoints, classes,
                     validation):
        """The whole run as one program (optional); variants without a
        lowering run eager only."""
        raise ValueError(
            f"protocol variant {self.name!r} has no compiled lowering; "
            f"use backend='eager'")


class ASCIIVariant(ProtocolVariant):
    """The paper's protocol: ignorance-score interchange around the chain
    (Algorithm 1 lines 3-11), and the stale-read async barrier."""

    name = "ascii"

    def bind(self, session: "Session") -> None:
        sc = session.scenario
        if sc is not None and sc.clock_skew \
                and session.state.proto is None:
            # the clock-skew history: agent m reads the score of skew_m
            # barriers ago
            session.state.proto = {"w_hist": [session.state.w]}

    def run_round(self, session: "Session", order: list[int],
                  rec: dict) -> bool:
        """One round over ``order``; True when the alpha <= 0 stop fired."""
        st, cfg = session.state, session.cfg
        eps = {ep.agent_id: ep for ep in session.endpoints}
        rec.setdefault("alphas", [])
        rec.setdefault("accs", [])
        if session.scheduler.stale:
            return session._step_stale(order, eps, rec)
        reweight, standard = session._reweight()
        k = cfg.num_classes
        t = st.round
        channel = session.transport.has_channel
        u = torch.ones_like(st.w)
        for j, m in enumerate(order):
            dst = eps[order[(j + 1) % len(order)]]
            with span_of(session.telemetry, "hop", src=eps[m].name,
                         dst=dst.name):
                params = eps[m].fit_local(session.draws.fit(st.key, t, j),
                                          session.classes,
                                          session.fit_weight(m, st.w), k)
                r = eps[m].reward(params, session.classes)
                a, rbar = scores.model_weight(
                    st.w, r, k, u=u if cfg.upstream and j > 0 else None,
                    alpha_cap=cfg.alpha_cap)
                alpha = float(a)
                rec["alphas"].append(alpha)
                rec["accs"].append(float(rbar))
                session.scheduler.observe(m, float(rbar))
                if cfg.stop_on_negative_alpha and alpha <= 0:
                    return True        # Algorithm 1, line 8
                st.components.append(Component(m, st.round, alpha, params))
                u = scores.upstream_factor_update(u, a, r, k)
                link_state = (None if st.codec_state is None
                              else st.codec_state.get(eps[m].name))
                st.w, link_state = session.transport.interchange(
                    eps[m], dst, st.w, r, a, reweight, standard,
                    draws=(session.draws.hop(st.key, t, j) if channel
                           else None),
                    codec_state=link_state)
                if link_state is not None:
                    if st.codec_state is None:
                        st.codec_state = {}
                    st.codec_state[eps[m].name] = link_state
        return False

    def fitted(self, session: "Session") -> FittedASCII:
        return FittedASCII(session.state.components,
                           [ep.learner for ep in session.endpoints],
                           session.cfg.num_classes, session.state.history)


# ================================================================ session state
#: The channel bookkeeping the port restores (``SessionState.comm``): DP
#: releases, budget spend, the controller's EMA and the scheduler's state.
#: A checkpoint's other ``comm`` keys are dropped on load, as the
#: reference's ``_comm_restore`` reads these with ``snap.get`` and ignores
#: the rest.
COMM_KEYS = ("releases", "ledger_bits", "link_spent", "exhausted",
             "ctrl_state", "scheduler")


@dataclass
class SessionState:
    """Explicit, checkpointable protocol state, in the reference's
    checkpoint format (``train/checkpoint.py``): saving mid-run and resuming
    reproduces the exact trajectory."""

    w: torch.Tensor
    key: np.ndarray              # opaque uint32 key data
    round: int = 0
    components: list[Component] = field(default_factory=list)
    history: list[dict] = field(default_factory=list)
    stopped: bool = False
    best_val: float = -1.0
    cv_stale: int = 0
    # per-round active-agent counts (scheduler-RNG replay on resume) and
    # the endpoint active flags at checkpoint time
    order_sizes: list[int] = field(default_factory=list)
    active: list[bool] | None = None
    # per-link wire-codec state (top-k error-feedback residuals, keyed by
    # sender name): checkpointed, so a lossy channel resumes exactly
    codec_state: dict | None = None
    # JSON-able channel bookkeeping captured at checkpoint time (budget
    # spend, link spend, exhaustion, DP release counts), in the reference's
    # ``Session._comm_snapshot`` format
    comm: dict | None = None
    # protocol-variant state, a tree of tensors: FedAvg's flat global
    # params ``{"g"}``, Assisted Learning's running residual ``{"R"}``, the
    # clock-skew history ``{"w_hist": [...]}``; None for plain ASCII
    proto: Any = None

    def to_tree(self) -> tuple[dict, dict]:
        """Split into (array tree, JSON-able metadata)."""
        tree = {"w": self.w,
                "key": self.key,
                "params": [c.params for c in self.components],
                "codec_state": self.codec_state,
                "proto": self.proto}
        meta = {"round": self.round,
                "stopped": self.stopped,
                "best_val": self.best_val,
                "cv_stale": self.cv_stale,
                "history": self.history,
                "order_sizes": self.order_sizes,
                "active": self.active,
                "comm": self.comm,
                "components": [{"agent": c.agent, "round": c.round,
                                "alpha": c.alpha} for c in self.components]}
        return tree, meta

    @classmethod
    def from_tree(cls, tree: dict, meta: dict) -> "SessionState":
        comm = meta.get("comm")
        if comm is not None:
            comm = {k: v for k, v in comm.items() if k in COMM_KEYS} or None
        components = [
            Component(int(c["agent"]), int(c["round"]), float(c["alpha"]), p)
            for c, p in zip(meta["components"], tree["params"])]
        return cls(w=tree["w"],
                   key=key_data(tree["key"]),
                   round=int(meta["round"]),
                   components=components,
                   history=list(meta["history"]),
                   stopped=bool(meta["stopped"]),
                   best_val=float(meta["best_val"]),
                   cv_stale=int(meta["cv_stale"]),
                   order_sizes=[int(s) for s in meta.get("order_sizes", [])],
                   active=meta.get("active"),
                   codec_state=tree.get("codec_state"),
                   comm=comm,
                   proto=tree.get("proto"))

    def save(self, directory: str, step: int | None = None) -> str:
        from repro_torch.train import checkpoint
        tree, meta = self.to_tree()
        return checkpoint.save_structured(
            directory, self.round if step is None else step, tree, meta=meta)

    @classmethod
    def restore(cls, directory: str, step: int | None = None,
                device: str | torch.device = "cuda") -> "SessionState":
        from repro_torch.train import checkpoint
        tree, meta, _ = checkpoint.restore_structured(
            directory, step=step, device=resolve_device(device))
        return cls.from_tree(tree, meta)


# ======================================================================= config
@dataclass(frozen=True)
class SessionConfig:
    """Engine knobs."""
    num_classes: int
    max_rounds: int = 20
    upstream: bool = True             # eqs. 11/13 side info (False = -Simple)
    stop_on_negative_alpha: bool = True
    cv_patience: int = 2
    alpha_cap: float = 20.0
    exact_reweight: bool = False      # beyond-paper exact exp-loss reweight


def holdout_split(Xs: Sequence[torch.Tensor], classes: torch.Tensor,
                  fraction: float):
    """The paper's CV stop criterion split (Section III-C): reserve the
    trailing rows (aligned by sample ID) for validation."""
    cut = int(round((1.0 - fraction) * Xs[0].shape[0]))
    return ([x[:cut] for x in Xs], classes[:cut],
            [x[cut:] for x in Xs], classes[cut:])


# ====================================================================== session
class Session:
    """A live protocol run: endpoints + scheduler + transport + state.

    ``step()`` executes one interchange round and returns whether the
    session should continue; ``run()`` loops to completion.  Between steps
    callers may drop endpoints (``active = False``) or checkpoint.  Feature
    blocks, labels and validation data are placed on ``device``; every
    endpoint's learner must live on the same device type.  ``draws`` is the
    wire channel's draw source (default :class:`~repro_torch.comm.draws.
    ChannelDraws`).  ``variant`` is the round rule (ASCII by default;
    FedAvg and Assisted Learning in :mod:`repro_torch.scenarios`),
    ``scenario`` a :class:`~repro_torch.scenarios.Scenario`: its
    participation mask filters each round's order, its shard masks the
    fit weights, its clock skew the async reads.  ``telemetry`` (a
    :class:`repro_torch.telemetry.Telemetry`) is attached to the transport
    before any traffic and only observes.
    """

    def __init__(self, cfg: SessionConfig, scheduler: Scheduler,
                 transport: Transport, endpoints: Sequence[AgentEndpoint],
                 classes: torch.Tensor, state: SessionState,
                 validation=None, variant: ProtocolVariant | None = None,
                 scenario=None, telemetry=None,
                 device: str | torch.device = "cuda",
                 draws: ChannelDraws | None = None,
                 _send_setup: bool = True) -> None:
        variant = variant if variant is not None else ASCIIVariant()
        if scheduler.stale and transport.controller is not None:
            raise ValueError(
                "adaptive controllers do not apply to the stale-read async "
                "path: their EMA statistic is defined on per-hop "
                "interchange, and the barrier releases once per round; "
                "drop controller= (codec/privacy/budget channels release "
                "per barrier and are supported)")
        if not isinstance(variant, ASCIIVariant):
            if scheduler.stale:
                raise ValueError(
                    f"the stale-read async barrier is an ASCII merge rule; "
                    f"protocol variant {variant.name!r} needs a "
                    f"sequential or random scheduler")
            if transport.controller is not None \
                    or transport.serve_controller is not None:
                raise ValueError(
                    "adaptive controllers read ignorance-vector statistics; "
                    f"they do not apply to protocol variant "
                    f"{variant.name!r} traffic — drop controller=/"
                    "serve_controller=")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scheduler = scheduler
        self.transport = transport
        # observation only: attached before any traffic so that the
        # registry sees every booking; nothing of the protocol reads it
        self.telemetry = telemetry
        if telemetry is not None:
            telemetry.attach_transport(transport)
        self.endpoints = list(endpoints)
        for i, ep in enumerate(self.endpoints):
            if ep.agent_id != i:
                raise ValueError("endpoint agent_ids must be 0..M-1")
            if ep.learner.torch_device.type != self.device.type:
                raise ValueError(f"{ep.name}'s learner lives on "
                                 f"{ep.learner.device}, the session on "
                                 f"{self.device}")
            ep.X = self._place(ep.X)
        self.classes = self._place(classes)
        self.state = state
        self.state.w = self._place(state.w)
        self.validation = None
        if validation is not None:
            Xs_val, c_val = validation
            self.validation = ([self._place(x) for x in Xs_val],
                               self._place(c_val))
        self.variant = variant
        self.scenario = scenario
        self.draws = draws if draws is not None else ChannelDraws()
        # per-session variant context (derived, not checkpointed: the
        # flattening template, one-hot labels, fit-weight tables)
        self.vctx: dict = {}
        if state.codec_state is not None:
            state.codec_state = {name: self._place(x)
                                 for name, x in state.codec_state.items()}
        if state.proto is not None:
            state.proto = tree_map(self._place, state.proto)
        self._participation = None
        self._shard_w = None
        if scenario is not None:
            scenario.validate(len(self.endpoints), scheduler, variant)
            self._participation = scenario.participation(
                cfg.max_rounds, len(self.endpoints))
            self._shard_w = scenario.shard_weights(
                self.classes, len(self.endpoints), self.device)
        transport.bind(self.endpoints)
        scheduler.bind_transport(transport)
        variant.bind(self)
        # the live plane: eager rounds tap the sink directly with the
        # round's registry deltas, metered transports only (an unmetered
        # run books nothing).  The counters are read before the collation
        # setup, so that its bits land in round 0's tap, as in the
        # compiled program's
        self._live = None
        if telemetry is not None and telemetry.live is not None \
                and getattr(transport, "log", None) is not None:
            self._live = telemetry.live
            self._live_prev = self._live_counters()
        if _send_setup:
            self._send_setup()

    def _place(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    # ---- telemetry ----------------------------------------------------------
    def _live_counters(self) -> tuple:
        """What an eager round tap differences: total wire bits, ignorance
        messages, budget skips, the exhausted flag."""
        reg = self.telemetry.registry
        return (reg.total("wire_bits_total"),
                reg.value("messages_total", kind="ignorance"),
                reg.total("budget_skips_total"),
                bool(getattr(self.transport, "exhausted", False)))

    def _emit_live_round(self, t: int) -> None:
        """One eager round tap: the payload the compiled program's
        ``emit_round`` stages (round, bits, sent, skipped, the exhaustion
        edge)."""
        bits, ign, skips, exh = cur = self._live_counters()
        p_bits, p_ign, p_skips, p_exh = self._live_prev
        self._live_prev = cur
        self._live.round_tap(t, int(bits - p_bits), int(ign - p_ign),
                             int(skips - p_skips), int(exh and not p_exh))

    def _send_setup(self) -> None:
        """Collation setup: the head agent shares labels and sample IDs
        with every other agent (metered under Fig. 4)."""
        n = int(self.classes.shape[0])
        head = self.endpoints[0].name
        for ep in self.endpoints[1:]:
            self.transport.send(LabelsMsg(head, ep.name, n))
            self.transport.send(SampleIdsMsg(head, ep.name, n))

    def _reweight(self):
        cfg = self.cfg
        if cfg.exact_reweight:
            return (lambda w, r, a: scores.ignorance_update_exact(
                w, r, a, cfg.num_classes)), False
        return scores.ignorance_update, True

    def fit_weight(self, m: int, w: torch.Tensor) -> torch.Tensor:
        """Agent m's fit weights: ``w`` masked to its non-IID shard and
        renormalized (the sum in float64, rounded: the same on the card and
        the CPU); ``w`` itself under IID."""
        if self._shard_w is None:
            return w
        return shard_fit_weight(w, self._shard_w[m])

    # ---- the round loop -----------------------------------------------------
    def step(self) -> bool:
        """One interchange round (Algorithm 1 lines 3-11 / the Section-IV
        chain).  Returns False once the session stopped."""
        st, cfg = self.state, self.cfg
        if st.stopped or st.round >= cfg.max_rounds:
            return False
        if getattr(self.transport, "exhausted", False):
            # the session bit budget can no longer afford even the cheapest
            # codec rung: stop scheduling rounds
            st.stopped = True
            return False
        t = st.round
        active = [ep.agent_id for ep in self.endpoints if ep.active]
        if not active:
            st.stopped = True          # everyone dropped out
            return False
        order = self.scheduler.round_order(t, active)
        # the order's size before churn: a resume replays the scheduler's
        # draws from the active roster, then re-applies the participation
        st.order_sizes.append(len(order))
        rec: dict = {"round": t}
        if self._participation is not None:
            order = [m for m in order if self._participation[t, m]]
            rec["participants"] = list(order)
        # a round that churn emptied is empty, not a stop: stragglers return
        stop = False
        with span_of(self.telemetry, "round", step=t, agents=len(order)):
            if order:
                stop = self.variant.run_round(self, order, rec)
        if self.validation is not None:
            Xs_val, c_val = self.validation
            hits = (self.fitted().predict(Xs_val) == c_val).to(torch.float32)
            # sum * (1/n) in float32: the reference's mean, whose compiler
            # turns the division by a constant into this product
            val_acc = float(torch.sum(hits) * (1.0 / hits.numel()))
            rec["val_acc"] = val_acc
            if val_acc > st.best_val + 1e-9:
                st.best_val, st.cv_stale = val_acc, 0
            else:
                st.cv_stale += 1
                if st.cv_stale >= cfg.cv_patience:
                    stop = True        # out-sample error no longer decreasing
        st.history.append(rec)
        st.round += 1
        if stop:
            st.stopped = True
        if self._live is not None:
            self._emit_live_round(t)
        return not st.stopped and st.round < cfg.max_rounds

    def _step_stale(self, order: list[int], eps: dict, rec: dict) -> bool:
        """An async round: every agent in ``order`` fits against the same
        score (fit draws at (round, its place in the order)), then each
        positive alpha's update w * exp((alpha / M)(1 - r)) merges into one
        product (the unnormalized ignorance kernel), renormalized at the
        barrier.  Under a channel only the alphas cross per agent and the
        merged score is released once (``Transport.barrier_release``, with
        the barrier's draws); without one every agent ships its running
        product to the next.  True when no alpha was positive (the stop)."""
        st, cfg = self.state, self.cfg
        k = cfg.num_classes
        t = st.round
        fits = []
        for j, m in enumerate(order):
            w_read = self._stale_view(m)
            params = eps[m].fit_local(self.draws.fit(st.key, t, j),
                                      self.classes,
                                      self.fit_weight(m, w_read), k)
            r = eps[m].reward(params, self.classes)
            a, rbar = scores.model_weight(w_read, r, k,
                                          alpha_cap=cfg.alpha_cap)
            fits.append((m, params, r, a, rbar))
        w_next, partials = st.w, None
        any_pos = False
        total = len(order)
        channel = self.transport.has_channel
        for j, (m, params, r, a, rbar) in enumerate(fits):
            alpha = float(a)
            rec["alphas"].append(alpha)
            rec["accs"].append(float(rbar))
            self.scheduler.observe(m, float(rbar))
            if alpha <= 0:
                continue
            any_pos = True
            st.components.append(Component(m, t, alpha, params))
            # the 1/M damping keeps the product of M stale updates to the
            # sequential chain's movement per round
            w_next, partials = ops.ignorance_update_unnormalized(
                w_next, r, a / total)
            if channel:
                self.transport.send(ModelWeightMsg(eps[m].name, "barrier",
                                                   alpha))
            else:
                dst = eps[order[(j + 1) % total]]
                self.transport.send(IgnoranceMsg(eps[m].name, dst.name,
                                                 w_next))
                self.transport.send(ModelWeightMsg(eps[m].name, dst.name,
                                                   alpha))
        w_bar = ops.ignorance_normalize(w_next, partials)
        if not channel:
            st.w = w_bar
        else:
            link_state = (None if st.codec_state is None
                          else st.codec_state.get("barrier"))
            released, link_state = self.transport.barrier_release(
                eps[order[0]], w_bar, draws=self.draws.barrier(st.key, t),
                codec_state=link_state)
            if link_state is not None:
                if st.codec_state is None:
                    st.codec_state = {}
                st.codec_state["barrier"] = link_state
            if released is not None:
                st.w = released        # a skipped release stays stale
        self._push_stale_hist()
        return not any_pos and cfg.stop_on_negative_alpha

    def _stale_view(self, m: int) -> torch.Tensor:
        """The score agent ``m`` reads at the barrier: the current one, or
        under a clock skew the one of ``skew_m`` barriers ago."""
        skew = None if self.scenario is None else self.scenario.clock_skew
        if not skew or not skew[m]:
            return self.state.w
        hist = self.state.proto["w_hist"]
        return hist[max(0, len(hist) - 1 - int(skew[m]))]

    def _push_stale_hist(self) -> None:
        """Advance the bounded clock-skew history after a barrier merge."""
        skew = None if self.scenario is None else self.scenario.clock_skew
        if not skew:
            return
        hist = self.state.proto["w_hist"]
        hist.append(self.state.w)
        del hist[:-(max(int(s) for s in skew) + 1)]

    def run(self, max_rounds: int | None = None) -> SessionState:
        """Drive ``step()`` to completion (or for ``max_rounds`` more)."""
        budget = float("inf") if max_rounds is None else max_rounds
        with span_of(self.telemetry, "session", backend="eager",
                     agents=len(self.endpoints)):
            while budget > 0:
                budget -= 1
                if not self.step():
                    break
        return self.state

    # ---- results ------------------------------------------------------------
    def fitted(self):
        return self.variant.fitted(self)

    def predict_distributed(self, Xs: Sequence[torch.Tensor] | None = None,
                            max_round: int | None = None, *,
                            request=None) -> torch.Tensor:
        """Prediction as the protocol runs it: every endpoint ships its
        [n, K] ScoreBlockMsg to the head agent, which sums and argmaxes.
        The blocks cross the transport's serve channel
        (:meth:`Transport.serve_block`), with the draws of
        ``draws.serve(key, agent, request)``; a block a budget skips is
        left out (the answer degrades toward head-only)."""
        if not isinstance(self.variant, ASCIIVariant):
            raise ValueError(
                f"score-block serving is ASCII's prediction protocol; "
                f"variant {self.variant.name!r} predicts via "
                f"session.fitted().predict(Xs)")
        head = self.endpoints[0]
        serve = self.transport.has_serve_channel
        if self._live is not None:
            reg = self.telemetry.registry
            p_bits = reg.total("wire_bits_total")
            p_blk = reg.value("messages_total", kind="score_block")
            p_skips = reg.total("budget_skips_total")
        total = None
        with span_of(self.telemetry, "serve", backend="eager",
                     agents=len(self.endpoints)):
            for i, ep in enumerate(self.endpoints):
                X = None if Xs is None else self._place(Xs[i])
                block = ep.score_block(self.state.components,
                                       self.cfg.num_classes, X=X,
                                       max_round=max_round)
                if ep is not head:
                    draws = (self.draws.serve(self.state.key, i, request)
                             if serve else None)
                    block = self.transport.serve_block(ep, head, block,
                                                       draws=draws)
                    if block is None:
                        continue       # budget skip: head-only fallback
                total = block if total is None else total + block
        if self._live is not None:
            # one serve tap a request, the eager twin of the program's
            # emit_serve, differencing the same booked counters
            self._live.serve_tap(
                int(reg.total("wire_bits_total") - p_bits),
                int(reg.value("messages_total", kind="score_block")
                    - p_blk),
                int(reg.total("budget_skips_total") - p_skips))
        return torch.argmax(total, dim=-1)

    # ---- checkpointing ------------------------------------------------------
    def _comm_snapshot(self) -> dict | None:
        """JSON-able channel bookkeeping that must survive pause/resume:
        budget spend (the cap covers the whole session), DP release counts
        (epsilon composes across the resume), the controller's EMA (a
        float32, exact through JSON's float) and the scheduler's state."""
        t = self.transport
        snap: dict = {}
        if t.accountant is not None:
            snap["releases"] = dict(t.accountant.releases)
        if hasattr(t, "budget"):
            snap["ledger_bits"] = (int(t.log.total_bits)
                                   + int(t.carryover_bits))
            snap["link_spent"] = [[s, d, int(b)]
                                  for (s, d), b in t.link_spent.items()]
            snap["exhausted"] = bool(t.exhausted)
        if t.controller is not None:
            snap["ctrl_state"] = float(t.ctrl_state)
        state_dict = getattr(self.scheduler, "state_dict", None)
        if state_dict is not None:
            snap["scheduler"] = state_dict()
        return snap or None

    def _comm_restore(self, snap: dict | None) -> None:
        t = self.transport
        if not snap:
            return
        if snap.get("releases") and t.accountant is not None:
            t.accountant.releases.update(snap["releases"])
        if hasattr(t, "budget"):
            # the resumed transport's log starts empty; the paused run's
            # spend counts against the session cap via carryover_bits
            t.carryover_bits = int(snap.get("ledger_bits", 0))
            t.link_spent = {(s, d): b
                            for s, d, b in snap.get("link_spent", [])}
            t.exhausted = bool(snap.get("exhausted", False))
        if t.controller is not None and snap.get("ctrl_state") is not None:
            t.ctrl_state = np.float32(snap["ctrl_state"])
        load_state = getattr(self.scheduler, "load_state_dict", None)
        if load_state is not None and snap.get("scheduler") is not None:
            load_state(snap["scheduler"])

    def checkpoint(self, directory: str, step: int | None = None) -> str:
        """Save the live SessionState mid-run (resumable via
        ``Protocol.resume``)."""
        self.state.active = [ep.active for ep in self.endpoints]
        self.state.comm = self._comm_snapshot()
        return self.state.save(directory, step)


# ======================================================================= engine
BACKENDS = ("eager", "compiled")


class Protocol:
    """The ASCII engine: config + scheduler + transport, driving endpoints
    on ``device``.  ``start`` opens a fresh session, ``resume`` restores
    one from a checkpoint directory (fast-forwarding the scheduler RNG), and
    ``fit`` runs a session to completion.  With ``backend="compiled"``,
    ``fit`` runs the session as one program (``core/compiled.py``; a
    protocol variant's own lowering, ``variant.fit_compiled``) and replays
    its ledger; such a run has no live session to step, pause or
    checkpoint.  ``variant``, ``scenario`` and ``telemetry`` are handed to
    every session (see :class:`Session`); a compiled run attaches
    ``telemetry`` to the transport before its replay books the ledger,
    opens ``session`` around the program (fenced) and ``replay`` around
    the replay, and with ``telemetry.live`` installs the live sink around
    the program, whose rounds and serves tap it.
    """

    def __init__(self, cfg: SessionConfig, scheduler: Scheduler | None = None,
                 transport: Transport | None = None, backend: str = "eager",
                 variant: ProtocolVariant | None = None, scenario=None,
                 telemetry=None, device: str | torch.device = "cuda",
                 draws: ChannelDraws | None = None) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected "
                             f"{BACKENDS}")
        self.device = resolve_device(device)
        self.telemetry = telemetry
        self.cfg = cfg
        self.scheduler = (scheduler if scheduler is not None
                          else SequentialScheduler())
        self.transport = (transport if transport is not None
                          else InProcessTransport())
        self.variant = variant if variant is not None else ASCIIVariant()
        self.scenario = scenario
        self.draws = draws
        self.backend = backend
        self._session: Session | None = None
        self._compiled_result = None      # the last compiled run's result
        # (endpoints, plan, agent-major result) of the last compiled run:
        # what its serve step and the serve engine's add_session read
        self._compiled_ctx = None

    def _eager_only(self, what: str) -> None:
        if self.backend != "eager":
            raise ValueError(f"backend='compiled' runs fit-to-completion "
                             f"with no live session; {what} needs the eager "
                             f"backend")

    def start(self, key, endpoints: Sequence[AgentEndpoint],
              classes: torch.Tensor, validation=None) -> Session:
        """A fresh session; ``key`` is an int seed or uint32 key data."""
        self._eager_only("start")
        n = endpoints[0].X.shape[0]
        state = SessionState(w=scores.init_ignorance(n, device=self.device),
                             key=key_data(key))
        self.scheduler.reset()
        return Session(self.cfg, self.scheduler, self.transport, endpoints,
                       classes, state, validation=validation,
                       variant=self.variant, scenario=self.scenario,
                       telemetry=self.telemetry, device=self.device,
                       draws=self.draws)

    def resume(self, directory: str, endpoints: Sequence[AgentEndpoint],
               classes: torch.Tensor, validation=None,
               step: int | None = None) -> Session:
        """Restore a checkpointed session and continue where it left off."""
        state = SessionState.restore(directory, step=step, device=self.device)
        return self.resume_state(state, endpoints, classes, validation)

    def resume_state(self, state: SessionState,
                     endpoints: Sequence[AgentEndpoint],
                     classes: torch.Tensor, validation=None) -> Session:
        """Continue from a restored (or converted) SessionState."""
        self._eager_only("resume")
        self.scheduler.reset()
        self.scheduler.skip_to(state.order_sizes)
        if state.active is not None:
            if len(endpoints) != len(state.active):
                raise ValueError(
                    f"resume expects {len(state.active)} endpoints (the "
                    f"checkpointed session's roster), got {len(endpoints)}")
            for ep, flag in zip(endpoints, state.active):
                ep.active = bool(flag)
        session = Session(self.cfg, self.scheduler, self.transport,
                          endpoints, classes, state, validation=validation,
                          variant=self.variant, scenario=self.scenario,
                          telemetry=self.telemetry, device=self.device,
                          draws=self.draws, _send_setup=False)
        session._comm_restore(state.comm)
        return session

    def fit(self, key, endpoints: Sequence[AgentEndpoint],
            classes: torch.Tensor, validation=None):
        if self.backend == "compiled":
            if self.telemetry is not None:
                # before any booking: the replays (the engine's and the
                # variants') then emit through the transport's choke points
                self.telemetry.attach_transport(self.transport)
            if not isinstance(self.variant, ASCIIVariant):
                # a protocol variant owns its lowering (FedAvg's one
                # program, repro_torch.scenarios.compiled)
                self._session = self._compiled_ctx = None
                return self.variant.fit_compiled(self, key, endpoints,
                                                 classes, validation)
            return self._fit_compiled(key, endpoints, classes, validation)
        session = self.start(key, endpoints, classes, validation=validation)
        session.run()
        self._session = session
        return session.fitted()

    # ---- telemetry of the compiled backend ----------------------------------
    def _live_sink(self):
        """The live sink when the live plane applies to this run: telemetry
        opened it and the transport is metered (an unmetered run books no
        bits on either backend)."""
        if self.telemetry is not None and self.telemetry.live is not None \
                and getattr(self.transport, "log", None) is not None:
            return self.telemetry.live
        return None

    def _fit_compiled(self, key, endpoints: Sequence[AgentEndpoint],
                      classes: torch.Tensor, validation) -> FittedASCII:
        """The whole run as one program (``core/compiled.py``), then the
        transport's ledger replayed, so that the metering is the eager
        run's bit for bit.  The finished run is kept as a stopped session
        (its state and fitted ensemble) and as ``_compiled_ctx``, which
        :meth:`predict_distributed` serves through the compiled serve
        step."""
        from repro_torch.core import compiled
        if self.scenario is not None and not self.scenario.trivial:
            raise ValueError(
                "backend='compiled' does not lower ASCII scenario knobs "
                "(churn/subsampling/partitions change the chain per round); "
                "use backend='eager', or protocol='fedavg' whose lowering "
                "takes a participation mask")
        sched_plan = None
        if self.scheduler.stale:
            # the stale-read barrier lowers through its own program
            sched_plan = compiled.AsyncStalePlan()
        elif not isinstance(self.scheduler, SequentialScheduler):
            plan_fn = getattr(self.scheduler, "plan", None)
            if plan_fn is None:
                raise ValueError(
                    f"backend='compiled' supports sequential, "
                    f"budget-aware and async-stale scheduling, got "
                    f"{type(self.scheduler).__name__}")
            # the spend signal depends on the transport it will order by
            self.scheduler.bind_transport(self.transport)
            sched_plan = plan_fn()
        if validation is not None:
            raise ValueError("backend='compiled' does not support the CV "
                             "validation stop; use the eager backend")
        if not all(ep.active for ep in endpoints):
            raise ValueError("backend='compiled' assumes all endpoints "
                             "active for the whole run")
        t = self.transport
        plan = compiled.plan_for(
            [ep.learner for ep in endpoints], self.cfg.num_classes,
            max_rounds=self.cfg.max_rounds, upstream=self.cfg.upstream,
            stop_on_negative_alpha=self.cfg.stop_on_negative_alpha,
            alpha_cap=self.cfg.alpha_cap,
            exact_reweight=self.cfg.exact_reweight,
            # the channel the eager transport holds: the same codec,
            # mechanism, budget and controller objects
            codec=t.codec, privacy=t.privacy,
            budget=getattr(t, "budget", None), serve_codec=t.serve_codec,
            controller=t.controller, serve_controller=t.serve_controller,
            scheduler=sched_plan)
        for ep in endpoints:
            if ep.learner.torch_device.type != self.device.type:
                raise ValueError(f"{ep.name}'s learner lives on "
                                 f"{ep.learner.device}, the session on "
                                 f"{self.device}")
            ep.X = torch.as_tensor(ep.X, device=self.device)
        classes = torch.as_tensor(classes, device=self.device)
        live_sink = self._live_sink()
        stale = isinstance(sched_plan, compiled.AsyncStalePlan)
        run = compiled.async_session if stale else compiled.compiled_session
        # the fence closes the span when the program is done, not when its
        # launches are queued
        with span_of(self.telemetry, "session", backend="compiled",
                     agents=len(endpoints)), live_installed(live_sink):
            result = fence_of(self.telemetry, run(
                plan, key_data(key), [ep.X for ep in endpoints], classes,
                live=live_sink is not None, source=self.draws))
        learners = [ep.learner for ep in endpoints]
        fitted = (compiled.fitted_from_async_result(plan, result, learners)
                  if stale else
                  compiled.fitted_from_result(plan, result, learners))
        self.scheduler.reset()
        with span_of(self.telemetry, "replay", backend="compiled"):
            if stale:
                self._replay_traffic_async(endpoints, classes, result, plan)
            else:
                self._replay_traffic(endpoints, classes, result, plan)
        state = SessionState(w=result.w, key=key_data(key),
                             round=len(fitted.history),
                             components=fitted.components,
                             history=fitted.history, stopped=True)
        self._session = Session(self.cfg, self.scheduler, t, endpoints,
                                classes, state, device=self.device,
                                draws=self.draws, _send_setup=False)
        self._compiled_result = result
        # the serve step indexes agents positionally: the agent-major view
        # (an async result is agent-major already)
        self._compiled_ctx = (tuple(endpoints), plan, result if stale
                              else compiled.agent_major_result(result))
        return fitted

    def _replay_setup(self, endpoints: Sequence[AgentEndpoint],
                      n: int) -> None:
        """Bind the transport to ``endpoints`` and book the collation
        setup a session sends first (:meth:`Session._send_setup`)."""
        t = self.transport
        t.bind(endpoints)
        head = endpoints[0].name
        for ep in endpoints[1:]:
            t.send(LabelsMsg(head, ep.name, n))
            t.send(SampleIdsMsg(head, ep.name, n))

    def _replay_traffic(self, endpoints: Sequence[AgentEndpoint],
                        classes: torch.Tensor, result, plan) -> None:
        """Book the ledger a sequential eager run books: the collation
        setup, then an IgnoranceMsg and a ModelWeightMsg for every hop
        that shipped, at the encoded size of its rung, budget skips and
        spend, DP releases; a budget-aware scheduler sees its round orders
        and observations again; the controller's EMA and codec are left
        where the eager hops leave them."""
        t = self.transport
        n = int(classes.shape[0])
        self._replay_setup(endpoints, n)
        host = {f: result._asdict()[f].detach().cpu().numpy() for f in
                ("valid", "alphas", "accs", "executed", "sent",
                 "codec_idx", "order")}
        ladder = plan.ladder if plan.has_channel else None
        budget = plan.budget
        budgeted = budget is not None and hasattr(t, "link_spent")
        permuted = plan.scheduler is not None
        num = len(endpoints)
        for ti in range(host["valid"].shape[0]):
            if permuted and host["executed"][ti].any():
                self.scheduler.round_order(ti, list(range(num)))
            for j in range(num):
                src = endpoints[int(host["order"][ti, j])]
                dst = endpoints[int(host["order"][ti, (j + 1) % num])]
                if permuted and host["executed"][ti, j]:
                    self.scheduler.observe(src.agent_id,
                                           float(host["accs"][ti, j]))
                if not host["valid"][ti, j]:
                    continue
                link = (src.name, dst.name)
                rung = int(host["codec_idx"][ti, j])
                if not host["sent"][ti, j]:
                    if budgeted:
                        t.record_skip(link)
                    continue
                if budgeted:
                    # spend first, as the eager walk: it arms the rung the
                    # wire-priced booking stamps
                    t.record_spend(link, budget.hop_costs(n)[rung], rung)
                elif plan.controller is not None:
                    t.codec = plan.controller.ladder[rung]
                codec = ladder[rung] if ladder else None
                t.send(IgnoranceMsg(src.name, dst.name,
                                    result.w_trace[ti, j],
                                    wire_bits=(None if codec is None
                                               else codec.wire_bits(n))))
                t.send(ModelWeightMsg(src.name, dst.name,
                                      float(host["alphas"][ti, j])))
                if t.privacy is not None:
                    t.accountant.record(src.name)
        if budgeted:
            t.exhausted = bool(result.exhausted)
        if plan.controller is not None:
            t.ctrl_state = np.float32(float(result.ctrl_ema))

    def _replay_traffic_async(self, endpoints: Sequence[AgentEndpoint],
                              classes: torch.Tensor, result, plan) -> None:
        """Book the ledger an eager async run books: the collation setup,
        then each executed round's traffic.  Without a channel every
        positive agent's running merge (IgnoranceMsg) and alpha
        (ModelWeightMsg) to the next agent; with one, the positive agents'
        alphas to the synthetic ``"barrier"`` sender, then the round's one
        release from it to the head, at the encoded size of its rung
        (budget spend first), or its budget skip; DP releases, exhaustion."""
        t = self.transport
        n = int(classes.shape[0])
        head = endpoints[0].name
        self._replay_setup(endpoints, n)
        host = {f: result._asdict()[f].detach().cpu().numpy() for f in
                ("executed", "valid", "alphas", "sent", "codec_idx")}
        num = len(endpoints)
        budget = plan.budget
        budgeted = budget is not None and hasattr(t, "link_spent")
        for ti in range(host["valid"].shape[0]):
            if not host["executed"][ti].any():
                break
            if not plan.has_channel:
                for m in range(num):
                    if not host["valid"][ti, m]:
                        continue
                    dst = endpoints[(m + 1) % num].name
                    t.send(IgnoranceMsg(endpoints[m].name, dst,
                                        result.w_trace[ti, m]))
                    t.send(ModelWeightMsg(endpoints[m].name, dst,
                                          float(host["alphas"][ti, m])))
                continue
            for m in range(num):
                if host["valid"][ti, m]:
                    t.send(ModelWeightMsg(endpoints[m].name, "barrier",
                                          float(host["alphas"][ti, m])))
            link = ("barrier", head)
            if not host["sent"][ti]:
                if budgeted:
                    t.record_skip(link)
                continue
            rung = int(host["codec_idx"][ti])
            codec = plan.ladder[rung] if rung >= 0 else None
            if budgeted:
                # spend first, as the eager walk: it arms the rung the
                # wire-priced booking stamps
                t.record_spend(link, budget.payload_costs(n)[rung], rung)
            t.send(IgnoranceMsg("barrier", head, result.w_bar[ti],
                                wire_bits=(None if codec is None
                                           else codec.wire_bits(n))))
            if t.privacy is not None:
                t.accountant.record("barrier")
        if budgeted:
            t.exhausted = bool(result.exhausted)

    def predict_distributed(self, Xs: Sequence[torch.Tensor] | None = None,
                            max_round: int | None = None, *,
                            request=None) -> torch.Tensor:
        """Distributed prediction after :meth:`fit`, through the
        transport's serve channel: every endpoint's [n, K] ScoreBlockMsg
        goes to the head agent, which sums and argmaxes.  The compiled
        backend runs the serve step (:func:`repro_torch.core.compiled.
        serve_session`) and then books the serve ledger the eager path
        books (:meth:`_replay_serve`): predictions and ledgers are the
        eager backend's bit for bit.  Both draw from the session's key
        data and the ``request`` tag."""
        if self.backend == "eager":
            if self._session is None:
                raise RuntimeError("predict_distributed needs a completed "
                                   "fit() on this Protocol (or use "
                                   "Session.predict_distributed directly)")
            return self._session.predict_distributed(Xs, max_round,
                                                     request=request)
        from repro_torch.core import compiled
        if self._compiled_ctx is None:
            raise RuntimeError("predict_distributed needs a completed fit()")
        endpoints, plan, result = self._compiled_ctx
        Xs_serve = (tuple(ep.X for ep in endpoints) if Xs is None
                    else tuple(torch.as_tensor(x, device=self.device)
                               for x in Xs))
        valid = result.valid
        if max_round is not None:
            rounds = torch.arange(valid.shape[0], device=valid.device)
            valid = valid & (rounds <= max_round)[:, None]
        shape = (int(Xs_serve[0].shape[0]), self.cfg.num_classes)
        rem_session, rem_link = self._serve_remaining(endpoints, plan)
        live_sink = self._live_sink()
        with span_of(self.telemetry, "serve", backend="compiled",
                     agents=len(endpoints)), live_installed(live_sink):
            serve = fence_of(self.telemetry, compiled.serve_session(
                plan, result, self._session.state.key, Xs_serve,
                request=request, valid=valid, rem_session=rem_session,
                rem_link=rem_link, live=live_sink is not None,
                source=self.draws))
        with span_of(self.telemetry, "replay", backend="compiled"):
            self._replay_serve(endpoints, serve, shape, plan)
        return serve.preds

    def _serve_remaining(self, endpoints, plan):
        """The remaining budget the serve step starts from, read off the
        live transport: (session bits, each agent's link to the head),
        None where uncapped."""
        t, budget = self.transport, plan.budget
        if budget is None or not hasattr(t, "link_spent"):
            return None, None
        rem_s = (None if budget.session_bits is None
                 else budget.session_bits - t.log.total_bits
                 - t.carryover_bits)
        head = endpoints[0].name
        rem_l = (None if budget.link_bits is None
                 else [budget.link_bits - t.link_spent.get((ep.name, head), 0)
                       for ep in endpoints])
        return rem_s, rem_l

    def _replay_serve(self, endpoints, serve, shape, plan) -> None:
        """Book the serve ledger the eager path books: a ScoreBlockMsg for
        every block that shipped, at the encoded size of its rung, budget
        spend first and skips, DP releases, exhaustion."""
        head = endpoints[0]
        t = self.transport
        sent = serve.sent.cpu().numpy()
        rungs = serve.codec_idx.cpu().numpy()
        ladder = plan.serve_ladder
        budgeted = plan.budget is not None and hasattr(t, "link_spent")
        for j in range(1, len(endpoints)):
            link = (endpoints[j].name, head.name)
            if not sent[j]:
                if budgeted:
                    t.record_skip(link)
                continue
            rung = int(rungs[j])
            codec = ladder[rung] if rung >= 0 else None
            wire_bits = (int(codec.wire_bits(shape)) if codec is not None
                         else None)
            if budgeted:
                # spend first, as the eager walk: it arms the rung the
                # wire-priced booking stamps
                t.record_spend(link, wire_bits, rung)
            t.send(ScoreBlockMsg(endpoints[j].name, head.name,
                                 serve.blocks[j], wire_bits=wire_bits))
            if t.privacy is not None:
                t.accountant.record(endpoints[j].name)
        if budgeted:
            t.exhausted = bool(t.exhausted or bool(serve.exhausted))


def variant_setup(variant: str, seed: int = 0) -> tuple[Scheduler, bool]:
    """Map a ``variant`` string to (scheduler, upstream flag):

      ascii  -> sequential chain, upstream side info (eqs. 11/13)
      simple -> sequential chain, own-loss alphas only
      random -> random order per round, upstream side info
      async  -> stale-read parallel rounds (beyond the paper)
    """
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected {VARIANTS}")
    if variant == "random":
        return RandomScheduler(seed), True
    if variant == "async":
        return AsyncStaleScheduler(), True
    return SequentialScheduler(), variant != "simple"


def endpoints_for(learners: Sequence[Learner],
                  Xs: Sequence[torch.Tensor]) -> list[AgentEndpoint]:
    """Build the endpoint list for aligned (learner, feature-block) pairs."""
    if len(learners) != len(Xs):
        raise ValueError(f"{len(learners)} learners for {len(Xs)} blocks")
    return [AgentEndpoint(m, lr, X) for m, (lr, X) in
            enumerate(zip(learners, Xs))]

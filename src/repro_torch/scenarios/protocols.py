"""FedAvg and Assisted-Learning protocol variants on the ASCII wire.

Counterpart of ``repro/scenarios/protocols.py``.  Both are
:class:`~repro_torch.core.engine.ProtocolVariant`\\ s driven by the same
session loop, shipping their traffic through the same transports (codecs,
bit budgets, DP noise, accountants), so the byte and epsilon ledgers of
"ASCII vs FedAvg vs AL at equal budget" are comparable numbers:

  * :class:`FedAvgVariant`: one global model over a homogeneous roster.
    Each round every participating client warm-starts a local fit from the
    broadcast flat params ``g`` and uplinks its delta as a
    :class:`~repro_torch.core.engine.GradientMsg` through
    :meth:`Transport.ship`; the server (agent 0, whose own delta never
    crosses a wire) averages the deltas that arrived and broadcasts the new
    ``g`` raw.  The one-program lowering is
    :mod:`repro_torch.scenarios.compiled`, bit for bit the eager loop.
  * :class:`AssistedLearningVariant`: residual-fitting rounds (Xian et al.
    2020): the label one-hot starts as the residual ``R``; each agent of
    the ring fits a closed-form weighted ridge of ``R`` on its feature
    block, keeps it as a boosting component and ships the shrunk residual
    on as a :class:`~repro_torch.core.engine.ResidualMsg`.  Eager only.

The flat delta is the reference's ``ravel_pytree`` order: dict keys
sorted, lists in order (logistic ``b`` then ``w``; each MLP layer ``b``
then ``w``), so the int codecs' tiles and top-k's indices see the
reference's elements.  The programs below are the single definitions both
FedAvg backends run (as ``core.compiled`` shares ``LearnerCore.fit``
with the eager learners), and the sums that decide bits are fixed-order
or float64-rounded, so the card computes what the CPU computes.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.comm.draws import ChannelDraws
from repro_torch.core.engine import (ASCIIVariant, Component, GradientMsg,
                                     LabelsMsg, ProtocolVariant, ResidualMsg,
                                     SampleIdsMsg, SequentialScheduler,
                                     key_data, shard_fit_weight)
from repro_torch.telemetry.spans import fence_of, span_of


# ============================================================ flat parameters
def _leaves(tree, path=()):
    """(path, leaf) pairs in ``ravel_pytree`` order: dict keys sorted,
    lists and tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def ravel(tree) -> torch.Tensor:
    """A param tree as one flat float32 vector, in ``ravel_pytree``
    order."""
    return torch.cat([leaf.reshape(-1) for _, leaf in _leaves(tree)])


class FlatParams:
    """The fixed flattening of a core's params at one feature shape: the
    tree's structure and its leaves' shapes, ``size`` elements in all."""

    def __init__(self, tree) -> None:
        self.leaves = [(path, tuple(leaf.shape), int(leaf.numel()))
                       for path, leaf in _leaves(tree)]
        self.size = sum(s for _, _, s in self.leaves)
        self._skeleton = _skeleton(tree)

    def unravel(self, flat: torch.Tensor):
        """The param tree of ``flat`` (views into it, no copy)."""
        pieces, ofs = {}, 0
        for path, shape, size in self.leaves:
            pieces[path] = flat[ofs:ofs + size].reshape(shape)
            ofs += size
        return _build(self._skeleton, (), pieces)


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(v) for v in tree)
    return None


def _build(skel, path, pieces):
    if isinstance(skel, dict):
        return {k: _build(v, path + (k,), pieces) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(_build(v, path + (i,), pieces)
                          for i, v in enumerate(skel))
    return pieces[path]


@functools.lru_cache(maxsize=256)
def param_template(core, shapes: tuple) -> FlatParams:
    """The flattening every GradientMsg payload of ``core`` at feature
    ``shapes`` uses (its params' structure, from an init on fixed
    draws)."""
    zero_key = np.zeros(2, dtype=np.uint32)
    return FlatParams(core.init(ChannelDraws().fit(zero_key, 0, 0), shapes))


# ============================================================ FedAvg programs
def one_hot(classes: torch.Tensor, k: int) -> torch.Tensor:
    """[n, k] float32 one-hot labels."""
    return (classes.to(torch.int64)[:, None]
            == torch.arange(k, device=classes.device)).to(torch.float32)


def fedavg_init_flat(core, shapes: tuple, draws) -> torch.Tensor:
    """The flat global init ``g0``: the core's init from ``draws`` (the
    session's :meth:`~repro_torch.comm.draws.ChannelDraws.init`),
    flattened."""
    return ravel(core.init(draws, shapes))


def fedavg_local_delta(core, shapes: tuple, g: torch.Tensor, draws, X,
                       onehot, w) -> torch.Tensor:
    """One client update: the core's fit warm-started from the broadcast
    flat params, and its flat delta (the GradientMsg payload)."""
    local = core.fit(param_template(core, shapes).unravel(g), draws, X,
                     onehot, w)
    return ravel(local) - g


def fedavg_combine(g: torch.Tensor, stack: torch.Tensor, mask: torch.Tensor,
                   lr: float) -> torch.Tensor:
    """The server's round merge: the deltas that arrived (``mask`` [M]
    bool over ``stack`` [M, d]) averaged, and ``g`` stepped by ``lr``
    times that.  The sum runs slot by slot from zero, one add a slot: the
    same order on the card and the CPU, in both backends."""
    cnt = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    delta = torch.zeros_like(g)
    for j in range(stack.shape[0]):
        delta = delta + torch.where(mask[j], stack[j], 0.0)
    return g + (float(lr) * delta) / cnt


def fedavg_eval(core, shapes: tuple, g: torch.Tensor, Xs) -> torch.Tensor:
    """FedAvg's prediction rule: the mean of the global model's logits
    over the agents' feature blocks (a vertical split gives one averaged
    model nothing better; that handicap is what the comparison with ASCII
    measures)."""
    params = param_template(core, shapes).unravel(g)
    total = core.logits(params, Xs[0])
    for X in Xs[1:]:
        total = total + core.logits(params, X)
    return total / float(len(Xs))


def _accuracy(preds: torch.Tensor, classes: torch.Tensor) -> float:
    """The reference's float32 mean, sum * (1/n)."""
    hits = (preds == classes).to(torch.float32)
    return float(torch.sum(hits) * (1.0 / hits.numel()))


def fedavg_train_acc(core, shapes: tuple, g, Xs, classes) -> float:
    """A round record's accuracy through :func:`fedavg_eval`, so eager
    records and the compiled replay's carry the same floats."""
    return _accuracy(torch.argmax(fedavg_eval(core, shapes, g, Xs), dim=-1),
                     classes)


def fedavg_fit_weights(classes, num_agents: int, scenario=None,
                       device=None) -> torch.Tensor:
    """[M, n] per-client fit weights: uniform rows, masked to the
    scenario's non-IID shard and renormalized (``Session.fit_weight``'s
    arithmetic on a uniform base).  Both backends take them as data."""
    if device is None:
        device = (classes.device if isinstance(classes, torch.Tensor)
                  else "cpu")
    n = int(classes.shape[0])
    base = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    masks = (None if scenario is None
             else scenario.shard_weights(classes, num_agents, device))
    if masks is None:
        return torch.stack([base] * num_agents)
    return torch.stack([shard_fit_weight(base, masks[m])
                        for m in range(num_agents)])


def _homogeneous_core(endpoints, num_classes: int):
    """FedAvg averages parameters, so the roster must be homogeneous:
    every agent a functional learner with the same core and feature
    shape."""
    cores, shapes = [], []
    for ep in endpoints:
        if not getattr(ep.learner, "functional", False):
            raise ValueError(
                f"fedavg averages model parameters; endpoint {ep.name!r}'s "
                f"{type(ep.learner).__name__} has no functional LearnerCore "
                f"(trees are eager-only) — use logistic/mlp learners")
        cores.append(ep.learner.core(num_classes))
        shapes.append(tuple(ep.X.shape[1:]))
    if any(c != cores[0] for c in cores[1:]):
        raise ValueError(
            "fedavg requires one shared model: all agents must hold "
            f"identically-configured learners, got "
            f"{sorted(set(map(repr, cores)))}")
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(
            "fedavg averages one global model over a fixed feature shape; "
            f"agents hold blocks of shapes {shapes} — pad or re-split the "
            "vertical partition into equal widths")
    return cores[0], shapes[0]


# ===================================================================== FedAvg
@dataclass
class FittedFedAvg:
    """FedAvg's trained result: the flat global params, predicting with
    :func:`fedavg_eval`."""
    core: object
    shapes: tuple
    g: torch.Tensor
    num_classes: int
    history: list = field(default_factory=list)

    def decision_scores(self, Xs) -> torch.Tensor:
        Xs = [torch.as_tensor(x, device=self.g.device) for x in Xs]
        return fedavg_eval(self.core, self.shapes, self.g, Xs)

    def predict(self, Xs) -> torch.Tensor:
        return torch.argmax(self.decision_scores(Xs), dim=-1)

    @property
    def num_rounds(self) -> int:
        return len(self.history)


@dataclass
class FedAvgVariant(ProtocolVariant):
    """Federated averaging over the shared channel (McMahan et al. 2017):
    uplink deltas through ``Transport.ship``, the new model broadcast back
    raw, the arrived deltas averaged at the server.  ``server_lr`` scales
    the averaged delta (1.0: plain FedAvg).  Agent 0 is the server: its own
    delta joins the average off the wire (no codec, no DP release, no
    budget charge).  Each roster slot's fit and uplink draw at ``(round,
    slot)``; the global init from the session key's own stream."""
    server_lr: float = 1.0

    name = "fedavg"

    def bind(self, session) -> None:
        k = session.cfg.num_classes
        core, shapes = _homogeneous_core(session.endpoints, k)
        session.vctx["core"] = core
        session.vctx["shapes"] = shapes
        session.vctx["onehot"] = one_hot(session.classes, k)
        session.vctx["fit_w"] = fedavg_fit_weights(
            session.classes, len(session.endpoints), session.scenario,
            session.device)
        if session.state.proto is None:
            session.state.proto = {"g": fedavg_init_flat(
                core, shapes, session.draws.init(session.state.key))}

    def run_round(self, session, order: list[int], rec: dict) -> bool:
        st = session.state
        eps = {ep.agent_id: ep for ep in session.endpoints}
        core, shapes = session.vctx["core"], session.vctx["shapes"]
        onehot, fit_w = session.vctx["onehot"], session.vctx["fit_w"]
        head = session.endpoints[0]
        channel = session.transport.has_channel
        part = set(order)
        t = st.round
        g = st.proto["g"]
        zero = torch.zeros_like(g)
        rows, mask = [], []
        for j in range(len(session.endpoints)):
            if j not in part:
                rows.append(zero)
                mask.append(False)
                continue
            dflat = fedavg_local_delta(core, shapes, g,
                                       session.draws.fit(st.key, t, j),
                                       eps[j].X, onehot, fit_w[j])
            if j == 0:
                rows.append(dflat)       # the server's own, off the wire
                mask.append(True)
                continue
            d_hat = session.transport.ship(
                eps[j], head, dflat, GradientMsg,
                draws=session.draws.hop(st.key, t, j) if channel else None)
            rows.append(zero if d_hat is None else d_hat)
            mask.append(d_hat is not None)
        g = fedavg_combine(g, torch.stack(rows),
                           torch.tensor(mask, device=g.device),
                           self.server_lr)
        st.proto["g"] = g
        # the new model to every participating client, raw fp32: priced at
        # d x 32 and counted against the session cap
        for m in order:
            if m != 0:
                session.transport.send(GradientMsg(head.name, eps[m].name,
                                                   g))
        rec["train_acc"] = fedavg_train_acc(
            core, shapes, g, [ep.X for ep in session.endpoints],
            session.classes)
        return False

    def fitted(self, session) -> FittedFedAvg:
        return FittedFedAvg(session.vctx["core"], session.vctx["shapes"],
                            session.state.proto["g"],
                            session.cfg.num_classes, session.state.history)

    # ---- the one-program lowering -------------------------------------------
    def fit_compiled(self, protocol, key, endpoints, classes, validation):
        """One-program FedAvg (:mod:`repro_torch.scenarios.compiled`) over
        the scenario's participation mask, then the ledger an eager run
        books replayed onto the live transport."""
        from repro_torch.scenarios import compiled as scompiled
        cfg = protocol.cfg
        if validation is not None:
            raise ValueError("backend='compiled' does not support the CV "
                             "validation stop; use the eager backend")
        if not (isinstance(protocol.scheduler, SequentialScheduler)
                and not protocol.scheduler.stale):
            raise ValueError(
                f"fedavg's compiled lowering supports sequential scheduling "
                f"only, got {type(protocol.scheduler).__name__}")
        if not all(ep.active for ep in endpoints):
            raise ValueError("backend='compiled' assumes all endpoints "
                             "active for the whole run (scenario churn is "
                             "fine — it rides the participation mask)")
        core, shapes = _homogeneous_core(endpoints, cfg.num_classes)
        device = protocol.device
        for ep in endpoints:
            if ep.learner.torch_device.type != device.type:
                raise ValueError(f"{ep.name}'s learner lives on "
                                 f"{ep.learner.device}, the session on "
                                 f"{device}")
            ep.X = torch.as_tensor(ep.X, device=device)
        classes = torch.as_tensor(classes, device=device)
        transport = protocol.transport
        scenario = protocol.scenario
        num = len(endpoints)
        mask = (np.ones((cfg.max_rounds, num), bool) if scenario is None
                else scenario.participation(cfg.max_rounds, num))
        plan = scompiled.FedAvgPlan(
            core=core, num_classes=cfg.num_classes, num_agents=num,
            max_rounds=cfg.max_rounds, server_lr=float(self.server_lr),
            codec=transport.codec, privacy=transport.privacy,
            budget=getattr(transport, "budget", None))
        Xs = tuple(ep.X for ep in endpoints)
        fit_w = fedavg_fit_weights(classes, num, scenario, device)
        tele = protocol.telemetry
        with span_of(tele, "session", backend="compiled", variant=self.name,
                     agents=num):
            result = fence_of(tele, scompiled.fedavg_session(
                plan, key_data(key), Xs, classes, mask, fit_w,
                source=protocol.draws))
        self._replay(protocol, endpoints, classes, result, plan, mask)
        history = self._history(core, shapes, result, mask, Xs, classes,
                                scenario)
        return FittedFedAvg(core, shapes, result.g, cfg.num_classes, history)

    @staticmethod
    def _history(core, shapes, result, mask, Xs, classes, scenario):
        """The round records an eager run writes, rebuilt from the
        program's trace of ``g`` through the same eval."""
        executed = result.executed.cpu().numpy()
        history = []
        for t in range(executed.shape[0]):
            if not executed[t]:
                continue
            rec: dict = {"round": t}
            parts = [int(j) for j in np.flatnonzero(mask[t])]
            if scenario is not None:
                rec["participants"] = parts
            if parts:
                rec["train_acc"] = fedavg_train_acc(
                    core, shapes, result.g_trace[t], Xs, classes)
            history.append(rec)
        return history

    @staticmethod
    def _replay(protocol, endpoints, classes, result, plan, mask) -> None:
        """Book the eager run's ledger: the collation setup, a GradientMsg
        uplink for every sent (round, client) at the rung the program
        chose, budget spend first and skips, DP releases, the raw broadcast
        to every participating client, then the exhaustion."""
        transport = protocol.transport
        transport.bind(endpoints)
        n = int(classes.shape[0])
        head = endpoints[0]
        for ep in endpoints[1:]:
            transport.send(LabelsMsg(head.name, ep.name, n))
            transport.send(SampleIdsMsg(head.name, ep.name, n))
        d = param_template(plan.core, tuple(endpoints[0].X.shape[1:])).size
        flat = torch.zeros((d,))          # the ledger prices size only
        executed = result.executed.cpu().numpy()
        sent = result.sent.cpu().numpy()
        rungs = result.codec_idx.cpu().numpy()
        budget = plan.budget
        budgeted = budget is not None and hasattr(transport, "link_spent")
        costs = None if budget is None else budget.payload_costs((d,))
        for t in range(executed.shape[0]):
            if not executed[t]:
                continue
            for j in range(1, len(endpoints)):
                if not mask[t, j]:
                    continue
                link = (endpoints[j].name, head.name)
                if not sent[t, j]:
                    if budgeted:
                        transport.record_skip(link)
                    continue
                codec = plan.codec
                if budget is not None:
                    codec = budget.ladder[int(rungs[t, j])]
                if budgeted:
                    # spend first, as the eager walk: it arms the rung the
                    # wire-priced booking stamps
                    rung = int(rungs[t, j])
                    transport.record_spend(link, costs[rung], rung)
                transport.send(GradientMsg(
                    endpoints[j].name, head.name, flat,
                    wire_bits=(None if codec is None
                               else int(codec.wire_bits((d,))))))
                if transport.privacy is not None:
                    transport.accountant.record(endpoints[j].name)
            for j in range(1, len(endpoints)):
                if mask[t, j]:
                    transport.send(GradientMsg(head.name, endpoints[j].name,
                                               flat))
        if budgeted:
            transport.exhausted = bool(result.exhausted)


# ========================================================== Assisted Learning
def _affine(X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[X, 1] @ B with the product summed in float64 and rounded, so the
    card's scores are the CPU's."""
    Xb = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                  device=X.device)], dim=1)
    return (Xb.to(torch.float64) @ B.to(torch.float64)).to(torch.float32)


def ridge_hop(X: torch.Tensor, R: torch.Tensor, w: torch.Tensor,
              l2: float, lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One AL hop: the closed-form weighted ridge of the residual R on the
    agent's biased feature block, and the shrunk residual it ships,

        B = (Xb' W Xb + l2 I)^-1 Xb' W R,   R' = R - lr (Xb B).

    Xb' W Xb and Xb' W R are summed in float64 and rounded (as the port's
    other sums), the system solved in float64 from those float32 values
    and B rounded: the same on the card and the CPU."""
    Xb = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                  device=X.device)], dim=1)
    Xw = (Xb * w[:, None]).to(torch.float64)
    gram = (Xw.T @ Xb.to(torch.float64)).to(torch.float32)
    rhs = (Xw.T @ R.to(torch.float64)).to(torch.float32)
    A = gram + l2 * torch.eye(Xb.shape[1], dtype=X.dtype, device=X.device)
    B = torch.linalg.solve(A.to(torch.float64),
                           rhs.to(torch.float64)).to(torch.float32)
    return R - lr * _affine(X, B), B


@dataclass
class FittedAL:
    """The AL boosting ensemble: each component's lr-scaled ridge scores
    on its own feature block, summed in component order, argmaxed."""
    components: list
    num_classes: int
    history: list = field(default_factory=list)

    def decision_scores(self, Xs) -> torch.Tensor:
        device = self.components[0].params.device if self.components \
            else "cpu"
        Xs = [torch.as_tensor(x, device=device) for x in Xs]
        total = torch.zeros((Xs[0].shape[0], self.num_classes),
                            dtype=torch.float32, device=device)
        for comp in self.components:
            total = total + comp.alpha * _affine(Xs[comp.agent], comp.params)
        return total

    def predict(self, Xs) -> torch.Tensor:
        return torch.argmax(self.decision_scores(Xs), dim=-1)

    @property
    def num_rounds(self) -> int:
        return max((c.round for c in self.components), default=-1) + 1


@dataclass
class AssistedLearningVariant(ProtocolVariant):
    """Assisted Learning's residual-fitting rounds (Xian et al. 2020): the
    running [n, K] residual circulates the ring as a ResidualMsg, each
    agent boosting it down with a private closed-form ridge (``lr`` the
    shrinkage, ``l2`` the ridge strength).  A hop draws at its ring
    position ``(round, position)``.  Eager only: the data-dependent ring
    has no fixed-shape lowering."""
    lr: float = 0.5
    l2: float = 1e-3

    name = "al"

    def bind(self, session) -> None:
        n = int(session.classes.shape[0])
        num = len(session.endpoints)
        masks = (None if session.scenario is None
                 else session.scenario.shard_weights(session.classes, num,
                                                     session.device))
        session.vctx["fit_w"] = (
            torch.ones((num, n), dtype=torch.float32, device=session.device)
            if masks is None else masks)
        if session.state.proto is None:
            session.state.proto = {"R": one_hot(session.classes,
                                                session.cfg.num_classes)}

    def run_round(self, session, order: list[int], rec: dict) -> bool:
        st = session.state
        eps = {ep.agent_id: ep for ep in session.endpoints}
        fit_w = session.vctx["fit_w"]
        channel = session.transport.has_channel
        t = st.round
        R = st.proto["R"]
        for j, m in enumerate(order):
            R_next, B = ridge_hop(eps[m].X, R, fit_w[m], float(self.l2),
                                  float(self.lr))
            st.components.append(Component(m, t, float(self.lr), B))
            dst = eps[order[(j + 1) % len(order)]]
            shipped = session.transport.ship(
                eps[m], dst, R_next, ResidualMsg,
                draws=session.draws.hop(st.key, t, j) if channel else None)
            # a budget skip: the next agent fits the stale residual
            R = R if shipped is None else shipped
        st.proto["R"] = R
        rec["resid_norm"] = float(torch.sqrt(torch.sum(
            R.to(torch.float64) ** 2)).to(torch.float32))
        rec["train_acc"] = _accuracy(
            self.fitted(session).predict([ep.X for ep in session.endpoints]),
            session.classes)
        return False

    def fitted(self, session) -> FittedAL:
        return FittedAL(session.state.components, session.cfg.num_classes,
                        session.state.history)


# ==================================================================== registry
PROTOCOLS = {
    "ascii": ASCIIVariant,
    "fedavg": FedAvgVariant,
    "al": AssistedLearningVariant,
}


def make_variant(name: str, **kw) -> ProtocolVariant:
    """Protocol-variant registry lookup for CLI names."""
    if name not in PROTOCOLS:
        raise ValueError(
            f"unknown protocol {name!r}; expected {sorted(PROTOCOLS)}")
    return PROTOCOLS[name](**kw)

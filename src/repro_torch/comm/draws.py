"""Where the session's random draws come from: the wire channel's and the
learners'.

No counterpart module in the reference, which derives every draw from its
session key: the channel's with ``fold_in`` tags (``repro/comm/codecs.py``:
``channel_apply`` and ``serve_key``), a learner's from the per-fit subkey
it is handed (``repro/core/engine.py``: one split per hop, and one more
per async barrier under a channel).  The port's functions take their
draws as arguments instead; this module supplies them.

:class:`ChannelDraws` is the source.  For one training hop
(:meth:`ChannelDraws.hop`), one async barrier's release
(:meth:`ChannelDraws.barrier`) or one prediction-time score block
(:meth:`ChannelDraws.serve`) it returns a :class:`HopDraws`, which hands the
channel its uniform ``u`` (stochastic rounding in the int codecs) and its
normal ``z`` (the Gaussian mechanism) on request.  For one learner fit
(:meth:`ChannelDraws.fit`, the fit at a hop's coordinates) it returns a
:class:`FitDraws`: the init's normals, the minibatch indices, the forest's
bootstrap counts and feature permutations, each purpose on a stream of
its own, so that one draw never shifts another.  The engine hands it to
the learner in the ``key`` slot of ``Learner.fit``.

The default source seeds a CPU ``torch.Generator`` per stream from a fixed
integer mix of the session's key data, a stream tag (codec, privacy) and
the hop's coordinates: the round and the hop's position in it, or the
agent index and the ``request`` tag for a serve block.  It draws on the CPU
and copies the draws to the payload's device.  The draws are therefore a
pure function of the saved state: a resumed session draws what the
uninterrupted one would, with no generator state saved, and a session on
the card draws what the same session on the CPU draws.  They are not the
reference's draws (JAX's threefry stream is not reproduced); a test that
holds a session to the reference passes a source that replays JAX's keys.

A hop's draws are indexed by the hop, never by how often the channel was
called: a hop that a budget skips still owns its coordinates, so the hops
after it draw the same numbers whether or not it shipped.

A compiled session (``core.compiled``) reads nothing from the host once it
runs, so :func:`session_draws` takes all of a session's draws before it:
every hop's uniforms and normals ``[round, slot, n]`` and every fit's draws
(its init and what else the learner reads), ``[F, round, slot, ...]`` for
a fleet of F keys.  They are the values ``hop(key, t, j)`` and
``fit(key, t, j)`` give, so a compiled session draws what the eager one
draws.  Every slot gets its draws, a hop that will be skipped or comes
after the stop included: the draws are indexed by coordinates, never by
what ran.  :class:`TensorHopDraws` hands one hop's slice to
``channel_apply``.  The compiled serve step's draws are taken the same
way (:func:`serve_draws`; :func:`serve_draws_batch` for a bucket of
requests): each agent's block's, as ``serve(key, agent, request)`` gives
them, a block that a budget will skip or admission holds back included.

The protocol variants draw by coordinates too: FedAvg one fit and one
hop a roster slot ``(round, slot)``, whether or not the slot takes part,
and its global init from :meth:`ChannelDraws.init`; Assisted Learning one
hop a ring position ``(round, position)``; ASCII under churn a fit and a
hop at its position in the round's filtered order.  The reference splits
its key once a hop it executes, so a test that replays its keys maps a
coordinate to the running count of splits.  The one-program FedAvg takes
its draws before it runs with :func:`session_draws` over the flat
delta's length (``repro_torch.scenarios.compiled.draws_for``).
"""
from __future__ import annotations

import numpy as np
import torch

# stream tags: the codec's uniforms and the mechanism's normals of one hop
# come from separate generators, so drawing one never shifts the other
CODEC_STREAM = 1
PRIVACY_STREAM = 2
# a fit's streams, one a purpose
INIT_STREAM = 3
MINIBATCH_STREAM = 4
BOOTSTRAP_STREAM = 5
FEATURE_STREAM = 6
# what a draw is for: a training hop, a prediction-time serve block, a
# learner's fit, an async barrier's release
HOP_SPACE = 0x484F50        # "HOP"
SERVE_SPACE = 0x535256      # "SRV"
FIT_SPACE = 0x464954        # "FIT"
BARRIER_SPACE = 0x424152    # "BAR"
INIT_SPACE = 0x494E49       # "INI": a global model's init (FedAvg's)

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def mix_seed(*words: int) -> int:
    """A 64-bit generator seed from a sequence of integers (each taken
    modulo 2^64), by chained splitmix64 finalizers."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


class HopDraws:
    """The draws of one hop or one serve block.  ``uniform`` gives floats in
    [0, 1), ``normal`` standard normals, both float32 of ``shape`` on
    ``device``.  Each stream is drawn afresh from its own seed on every
    request, so asking twice gives the same numbers."""

    def __init__(self, seed_words: tuple[int, ...]) -> None:
        self.seed_words = tuple(int(w) for w in seed_words)

    def _generator(self, stream: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            mix_seed(*self.seed_words, stream))

    def uniform(self, shape, device) -> torch.Tensor:
        u = torch.rand(tuple(shape), generator=self._generator(CODEC_STREAM),
                       dtype=torch.float32)
        return u.to(device)

    def normal(self, shape, device) -> torch.Tensor:
        z = torch.randn(tuple(shape),
                        generator=self._generator(PRIVACY_STREAM),
                        dtype=torch.float32)
        return z.to(device)


class FitDraws:
    """The draws of one learner fit.  Each request is indexed (a layer, a
    step, a tree) and seeds its own generator from the fit's coordinates,
    its purpose's stream tag and the index, so asking twice gives the same
    numbers and the order of requests does not matter.  Drawn on the CPU
    and copied to ``device``."""

    def __init__(self, seed_words: tuple[int, ...]) -> None:
        self.seed_words = tuple(int(w) for w in seed_words)

    def generator(self, stream: int = INIT_STREAM,
                  index: int = 0) -> torch.Generator:
        """The CPU generator of ``stream``'s draw ``index`` (a model's init
        draws its whole tree from one)."""
        return torch.Generator().manual_seed(
            mix_seed(*self.seed_words, stream, int(index)))

    def normal(self, shape, index: int = 0, device="cpu") -> torch.Tensor:
        """Standard normals, float32: init draw ``index`` (a layer)."""
        z = torch.randn(tuple(shape), generator=self.generator(
            INIT_STREAM, index), dtype=torch.float32)
        return z.to(device)

    def randint(self, shape, high: int, step: int,
                device="cpu") -> torch.Tensor:
        """Integers uniform in [0, high), int64: minibatch ``step``'s rows."""
        idx = torch.randint(int(high), tuple(shape), generator=self.generator(
            MINIBATCH_STREAM, step), dtype=torch.int64)
        return idx.to(device)

    def poisson(self, shape, index: int = 0, device="cpu") -> torch.Tensor:
        """Poisson(1) counts, int32: bootstrap ``index`` (a tree)."""
        counts = torch.poisson(torch.ones(tuple(shape), dtype=torch.float32),
                               generator=self.generator(BOOTSTRAP_STREAM,
                                                        index))
        return counts.to(torch.int32).to(device)

    def permutation(self, n: int, index: int = 0,
                    device="cpu") -> torch.Tensor:
        """A permutation of range(n), int64: feature draw ``index`` (a
        tree)."""
        perm = torch.randperm(int(n), generator=self.generator(
            FEATURE_STREAM, index), dtype=torch.int64)
        return perm.to(device)


def fit_draws(key) -> "FitDraws":
    """``key`` as a learner's draws: an int seed or uint32 key data gives
    the default source's draws of the fit at (0, 0); anything else is a
    draw object (a :class:`FitDraws`, or a test's replay of the
    reference's keys) and is taken as it is."""
    if key is None:
        raise ValueError("this learner draws random numbers: pass a FitDraws "
                         "(ChannelDraws().fit(key, round, position)) or a "
                         "seed as its key")
    if isinstance(key, (int, np.integer)):
        key = np.array([0, int(key) & 0xFFFFFFFF], dtype=np.uint32)
    if isinstance(key, (np.ndarray, torch.Tensor, list, tuple)):
        return ChannelDraws().fit(key, 0, 0)
    return key


class ChannelDraws:
    """The default draw source (see the module note).  ``key`` is the
    session's uint32 key data."""

    @staticmethod
    def _key_words(key) -> tuple[int, ...]:
        return tuple(int(k) for k in np.asarray(key, dtype=np.uint32).ravel())

    def hop(self, key, round_idx: int, position: int) -> HopDraws:
        """Draws of the hop at ``position`` in round ``round_idx``."""
        return HopDraws((*self._key_words(key), HOP_SPACE, int(round_idx),
                         int(position)))

    def fit(self, key, round_idx: int, position: int) -> FitDraws:
        """Draws of the learner fit at ``position`` in round ``round_idx``
        (the hop's coordinates; in an async round, the agent's place in
        the round's order)."""
        return FitDraws((*self._key_words(key), FIT_SPACE, int(round_idx),
                         int(position)))

    def init(self, key) -> FitDraws:
        """Draws of a session's global model init (FedAvg's ``g0``; the
        reference folds ``FEDAVG_INIT_FOLD`` off the session key), apart
        from every fit's."""
        return FitDraws((*self._key_words(key), INIT_SPACE))

    def barrier(self, key, round_idx: int) -> HopDraws:
        """Draws of round ``round_idx``'s async barrier release."""
        return HopDraws((*self._key_words(key), BARRIER_SPACE,
                         int(round_idx)))

    def serve(self, key, agent_index: int, request=None) -> HopDraws:
        """Draws of agent ``agent_index``'s score block in the prediction
        call tagged ``request`` (None: the untagged call)."""
        tag = (0, 0) if request is None else (1, int(request))
        return HopDraws((*self._key_words(key), SERVE_SPACE, *tag,
                         int(agent_index)))


# ============================================================ a whole session
class TensorHopDraws:
    """One hop's draws as tensors taken ahead (a compiled session's slice
    of :func:`session_draws`): ``uniform`` and ``normal`` return them."""

    def __init__(self, u: torch.Tensor | None, z: torch.Tensor | None):
        self.u, self.z = u, z

    @staticmethod
    def _take(x, shape, what):
        if x is None or tuple(x.shape) != tuple(shape):
            raise ValueError(f"no {what} draws of shape {tuple(shape)} were "
                             f"taken for this hop")
        return x

    def uniform(self, shape, device=None) -> torch.Tensor:
        return self._take(self.u, shape, "uniform")

    def normal(self, shape, device=None) -> torch.Tensor:
        return self._take(self.z, shape, "normal")


def stack_trees(trees: list):
    """Stack matching trees (dicts, lists, tuples of tensors) along a new
    leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


def session_draws(keys, rounds: int, slots: int, n: int, fit, *,
                  uniform: bool = False, normal: bool = False,
                  device="cpu", source=None, fleet: bool = False,
                  barrier: bool = False) -> dict:
    """Every draw of a session, taken before it runs: ``{"fit": [slot j's
    fit draws, each leaf [rounds, ...]], "u": [rounds, slots, n],
    "z": [rounds, slots, n]}`` (``u``, the codecs' uniforms, when
    ``uniform``; ``z``, the mechanism's normals, when ``normal``).
    ``fit(j, fit_draws)`` turns slot j's :class:`FitDraws` into its tree
    of tensors (``LearnerCore.draw``).  ``keys`` is the session's key
    data, or with ``fleet`` a sequence of F keys, and then every leaf has
    a leading [F] axis.  ``source`` is the draw source (default
    :class:`ChannelDraws`), or with ``fleet`` one source a key.  With
    ``barrier`` (an async session) ``u`` and ``z`` are ``[rounds, n]``,
    each round's barrier release's (:meth:`ChannelDraws.barrier`), and the
    fits are the agents' at their place in the round."""
    if not fleet:
        keys, source = [keys], [source]
    elif not isinstance(source, (list, tuple)):
        source = [source] * len(keys)
    sessions = []
    for key, src in zip(keys, source):
        src = ChannelDraws() if src is None else src
        out = {"fit": [stack_trees([fit(j, src.fit(key, t, j))
                                    for t in range(rounds)])
                       for j in range(slots)]}
        hops = ([[src.barrier(key, t)] for t in range(rounds)] if barrier
                else [[src.hop(key, t, j) for j in range(slots)]
                      for t in range(rounds)])
        # drawn on the host, then one copy to the device
        if uniform:
            out["u"] = torch.stack([torch.stack([h.uniform((n,), "cpu")
                                                 for h in row])
                                    for row in hops]).to(device)
        if normal:
            out["z"] = torch.stack([torch.stack([h.normal((n,), "cpu")
                                                 for h in row])
                                    for row in hops]).to(device)
        if barrier:
            out = {name: (d[:, 0] if name != "fit" else d)
                   for name, d in out.items()}
        sessions.append(out)
    return stack_trees(sessions) if fleet else sessions[0]


def serve_draws(key, request, agents: int, shape, *, uniform: bool = False,
                normal: bool = False, device="cpu", source=None) -> dict:
    """Every draw of one distributed prediction, taken before it runs:
    ``{"u": [agents, *shape], "z": [agents, *shape]}`` (``u``, the serve
    codecs' uniforms, when ``uniform``; ``z``, the mechanism's normals,
    when ``normal``).  Row j >= 1 holds what ``source.serve(key, j,
    request)`` gives agent j's block (default source
    :class:`ChannelDraws`); row 0, the head's block, never crosses the
    wire and holds zeros.  Hand row j to the channel as
    :class:`TensorHopDraws`."""
    return {name: d[0] for name, d in serve_draws_batch(
        [key], [request], agents, shape, uniform=uniform, normal=normal,
        device=device, source=[source]).items()}


def serve_draws_batch(keys, requests, agents: int, shape, *,
                      uniform: bool = False, normal: bool = False,
                      device="cpu", source=None) -> dict:
    """:func:`serve_draws` for a bucket's slots, stacked: leaves of
    ``[B, agents, *shape]``, slot b's the draws of ``keys[b]`` and
    ``requests[b]`` (``source`` one source, or one a slot).  Drawn on the
    host, then one copy a leaf to ``device``."""
    if not isinstance(source, (list, tuple)):
        source = [source] * len(keys)
    shape = tuple(int(s) for s in shape)
    out = {}
    for name, wanted in (("u", uniform), ("z", normal)):
        if not wanted:
            continue
        slots = []
        for key, request, src in zip(keys, requests, source):
            src = ChannelDraws() if src is None else src
            rows = [torch.zeros(shape, dtype=torch.float32)]
            for j in range(1, agents):
                hop = src.serve(key, j, request)
                rows.append(hop.uniform(shape, "cpu") if name == "u"
                            else hop.normal(shape, "cpu"))
            slots.append(torch.stack(rows))
        out[name] = torch.stack(slots).to(device)
    return out

"""The port's ASCII sessions through the wire channel against the JAX
package's, end to end, on the blob3 n=300 data of tests/test_engine.py.

The reference derives its channel draws from its session key (split per
hop, then ``fold_in(COMM_FOLD)`` and the codec's or the mechanism's tag);
the port takes them from a draw source.  ``ReplayDraws`` below is such a
source built from ``jax.random``: it hands the port the reference's own
uniforms and normals, hop by hop and serve block by serve block.

Exactly equal: the components (agent, round), the stop round, the ledger
(every entry: sender, receiver, kind, bits and budget rung), the budget's
skips and exhaustion and the accountant's releases.  Within the tolerances
of tests/test_torch_session.py: the alphas (rtol 1e-5) and the ignorance
vector (atol 1e-6).

The port's ignorance update is within float32 rounding of the reference's,
not equal to it, and a codec can amplify that: an element that sits on a
floor boundary of the stochastic rounding (or on an fp16 rounding
midpoint) can go either way.  ``_first_divergent_hop`` replays the two
sessions hop by hop and, at the first hop whose outputs part, asserts that
this is what happened there, or that the tree split there was decided by
rounding (the tree caveat of tests/test_torch_session.py).  The float
comparisons then hold up to that hop, the exact ones throughout, and the
predicted classes (``predict_distributed`` through the serve channel, and
the fitted ensemble) are equal when no hop parted.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import BudgetedTransport as JBudgeted
from repro.comm import BudgetSpec as JBudgetSpec
from repro.comm import codecs as jcodecs
from repro.comm.privacy import GaussianMechanism as JMech
from repro.control.accounting import RDPAccountant as JRDP
from repro.core import engine as J
from repro.core import scores as jsc
from repro.data.partition import train_test_split, vertical_split
from repro.data.synthetic import blob_fig3
from repro.learners.tree import DecisionTree as JTree
from repro_torch.comm import BudgetedTransport as TBudgeted
from repro_torch.comm import BudgetSpec as TBudgetSpec
from repro_torch.comm import codecs as tcodecs
from repro_torch.comm.privacy import GaussianMechanism as TMech
from repro_torch.control.accounting import RDPAccountant as TRDP
from repro_torch.convert import state_from_reference
from repro_torch.core import engine as T
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.launch import session as cli
from repro_torch.learners.tree import DecisionTree as TTree
from test_torch_learners import reference_chosen_scores

CPU = "cpu"
ROUNDS = 3


@pytest.fixture(scope="module")
def blob():
    ds = blob_fig3(jax.random.key(0), n=300)
    tr, te = train_test_split(0, 300)
    Xs = vertical_split(ds.X, ds.splits)
    return ([np.array(x[tr]) for x in Xs], np.array(ds.classes[tr]),
            [np.array(x[te]) for x in Xs], np.array(ds.classes[te]),
            ds.num_classes)


# ============================================================ replayed draws
class _ReplayHop:
    """The reference's draws for one hop key: ``channel_apply``'s folds."""

    def __init__(self, hop_key):
        self.hop_key = hop_key

    def _key(self, tag):
        return jax.random.fold_in(
            jax.random.fold_in(self.hop_key, jcodecs.COMM_FOLD), tag)

    def uniform(self, shape, device):
        u = jax.random.uniform(self._key(jcodecs.CODEC_FOLD), tuple(shape),
                               jnp.float32)
        return torch.from_numpy(np.array(u)).to(device)

    def normal(self, shape, device):
        z = jax.random.normal(self._key(jcodecs.PRIVACY_FOLD), tuple(shape),
                              jnp.float32)
        return torch.from_numpy(np.array(z)).to(device)


class _ReplayFit:
    """The reference's draws for one per-fit subkey, as the port's
    learners ask for them (``repro_torch.comm.draws.FitDraws``): the MLP's
    init normals (layer i: the i-th split of ``split(key)[1]``) and
    minibatch rows (``randint`` under ``fold_in(split(key)[0], step)``),
    the forest's bootstrap counts and feature permutations (tree t: the
    boot and feature keys of ``split(key, trees)[t]``)."""

    def __init__(self, sub, trees: int | None = None):
        self.sub = sub
        self.trees = trees

    def normal(self, shape, index=0, device=CPU):
        key = jax.random.split(self.sub)[1]
        for _ in range(index + 1):
            key, layer = jax.random.split(key)
        z = jax.random.normal(layer, tuple(shape), jnp.float32)
        return torch.from_numpy(np.array(z)).to(device)

    def randint(self, shape, high, step, device=CPU):
        key = jax.random.fold_in(jax.random.split(self.sub)[0], step)
        idx = jax.random.randint(key, tuple(shape), 0, high)
        return torch.from_numpy(np.array(idx)).long().to(device)

    def _tree_keys(self, t):
        return jax.random.split(jax.random.split(self.sub, self.trees)[t])

    def poisson(self, shape, index=0, device=CPU):
        counts = jax.random.poisson(self._tree_keys(index)[0], 1.0,
                                    tuple(shape))
        return torch.from_numpy(np.array(counts)).to(device)

    def permutation(self, n, index=0, device=CPU):
        perm = jax.random.permutation(self._tree_keys(index)[1], n)
        return torch.from_numpy(np.array(perm)).long().to(device)


class ReplayDraws:
    """A draw source that replays the reference's keys: its session key is
    split once per hop (hop h of a sequential session with M agents is
    round * M + position), and the subkey seeds both the hop's fit and its
    channel; a serve block's key is
    ``fold_in(serve_key(final_key, request), agent)``, where ``final_key``
    is the reference session's key after its run.  An async round splits
    once per agent and, under a channel, once more for its barrier
    (``per_round`` = M + 1).  ``trees`` is a forest's tree count (its
    per-tree keys depend on it)."""

    def __init__(self, key, agents: int, first_hop: int = 0,
                 per_round: int | None = None, trees: int | None = None):
        self.agents = agents
        self.per_round = agents if per_round is None else per_round
        self.trees = trees
        self._key = key
        self._subs: dict = {}
        self._next = first_hop
        self.final_key = None

    def _hop_key(self, h: int):
        while self._next <= h:
            self._key, sub = jax.random.split(self._key)
            self._subs[self._next] = sub
            self._next += 1
        return self._subs[h]

    def hop(self, key, round_idx, position):
        return _ReplayHop(self._hop_key(round_idx * self.per_round
                                        + position))

    def fit(self, key, round_idx, position):
        return _ReplayFit(self._hop_key(round_idx * self.per_round
                                        + position), self.trees)

    def barrier(self, key, round_idx):
        return _ReplayHop(self._hop_key(round_idx * self.per_round
                                        + self.agents))

    def serve(self, key, agent_index, request=None):
        return _ReplayHop(jax.random.fold_in(
            jcodecs.serve_key(self.final_key, request), agent_index))


# ================================================================= channels
def _jlearners(n):
    return [JTree(depth=3, num_thresholds=8) for _ in range(n)]


def _tlearners(n):
    return [TTree(depth=3, num_thresholds=8, device=CPU) for _ in range(n)]




def _budget_bits(n, agents, rungs=(0, 0, 1, 2, 3)):
    """A session cap that setup plus one hop at each listed ladder rung
    exhausts (with 100 bits to spare): the run degrades fp32 -> fp16 ->
    int8 -> int4, then skips and stops."""
    spec = JBudgetSpec()
    setup = (agents - 1) * 2 * n * 32
    return setup + sum(spec.hop_costs(n)[r] for r in rungs) + 100


CHANNELS = {
    "fp16": lambda n, m: ({"codec": jcodecs.Fp16Codec()},
                          {"codec": tcodecs.Fp16Codec()}),
    "int8": lambda n, m: ({"codec": jcodecs.QuantCodec(bits=8)},
                          {"codec": tcodecs.QuantCodec(bits=8)}),
    "int4+int8serve": lambda n, m: (
        {"codec": jcodecs.QuantCodec(bits=4),
         "serve_codec": jcodecs.QuantCodec(bits=8)},
        {"codec": tcodecs.QuantCodec(bits=4),
         "serve_codec": tcodecs.QuantCodec(bits=8)}),
    "topk": lambda n, m: ({"codec": jcodecs.TopKCodec()},
                          {"codec": tcodecs.TopKCodec()}),
    # epsilon 1: the noised weights (sum ~400) soon give a tree split whose
    # empty child's float32 residues decide it; epsilon 10 runs clean
    "dp": lambda n, m: ({"privacy": JMech(epsilon=1.0)},
                        {"privacy": TMech(epsilon=1.0)}),
    "dp10-rdp": lambda n, m: ({"privacy": JMech(epsilon=10.0),
                               "accountant": JRDP()},
                              {"privacy": TMech(epsilon=10.0),
                               "accountant": TRDP()}),
    "budget": lambda n, m: ({"budget": JBudgetSpec(
                                 session_bits=_budget_bits(n, m))},
                            {"budget": TBudgetSpec(
                                 session_bits=_budget_bits(n, m))}),
}


def _transports(name, n, m):
    jkw, tkw = CHANNELS[name](n, m)
    if "budget" in jkw:
        return JBudgeted(**jkw), TBudgeted(**tkw)
    return J.MeteredTransport(**jkw), T.MeteredTransport(**tkw)


def _record(transport):
    """Wrap ``transport.interchange`` to record each hop's inputs and the
    vector the receiver got (the stale one on a budget skip)."""
    hops = []
    inner = transport.interchange

    def interchange(src, dst, w, r, alpha, reweight, standard=True, **kw):
        out, state = inner(src, dst, w, r, alpha, reweight, standard, **kw)
        hops.append({"m": src.agent_id, "w": np.array(w), "r": np.array(r),
                     "alpha": float(alpha), "out": np.array(out),
                     "codec": transport.codec, "skipped": out is w})
        return out, state
    transport.interchange = interchange
    return hops


def _run_pair(blob, name, rounds=ROUNDS):
    """The reference and the port session on one channel, both run to the
    end, each hop recorded."""
    Xtr, ctr, _, _, k = blob
    m, n = len(Xtr), len(ctr)
    jt, tt = _transports(name, n, m)
    jhops, thops = _record(jt), _record(tt)
    key = jax.random.key(2)
    cfg = dict(num_classes=k, max_rounds=rounds)
    js = J.Protocol(J.SessionConfig(**cfg), transport=jt).start(
        key, J.endpoints_for(_jlearners(m), [jnp.asarray(x) for x in Xtr]),
        jnp.asarray(ctr))
    js.run()
    draws = ReplayDraws(key, m)
    ts = T.Protocol(T.SessionConfig(**cfg), transport=tt, device=CPU,
                    draws=draws).start(
        2, T.endpoints_for(_tlearners(m), [torch.from_numpy(x) for x in Xtr]),
        torch.from_numpy(ctr))
    ts.run()
    draws.final_key = js.state.key
    return js, ts, jhops, thops


def _first_divergent_hop(jhops, thops, draws, Xtr, ctr, k, first=0):
    """The index of the first recorded hop whose reward or received vector
    differs between the two sessions (None if none does), after asserting
    why it does: a tree split that rounding decides, or a codec that
    rounded an element sitting on a rounding boundary one way for the
    reference's update and the other way for the port's (which is within
    float32 rounding of it).  ``first`` is the session hop of record 0."""
    m = len(Xtr)
    for i, (jh, th) in enumerate(zip(jhops, thops)):
        h = first + i
        if not np.array_equal(jh["r"], th["r"]):
            _assert_split_decided_by_rounding(jh, th, Xtr[h % m], ctr, k)
            return i
        if jh["skipped"] or np.allclose(th["out"], jh["out"], rtol=1e-6,
                                        atol=1e-7):
            continue
        _assert_on_a_boundary(jh, draws.hop(None, h // m, h % m))
        return i
    return None


def _assert_split_decided_by_rounding(jh, th, X, ctr, k):
    """The two trees of a hop part.  Their inputs agree within float32
    rounding, and either the reference's own tree, fed the port's w, picks
    the port's split (rounding in the inputs decided it), or the two trees
    part on that same w at a split that ties in exact arithmetic."""
    np.testing.assert_allclose(th["w"], jh["w"], rtol=1e-5, atol=1e-7)
    Xj, cj, wj = jnp.asarray(X), jnp.asarray(ctr), jnp.asarray(th["w"])
    jtree = JTree(depth=3, num_thresholds=8)
    jp = jtree.fit(None, Xj, cj, wj, k)
    if np.array_equal(np.asarray(jtree.reward(jp, Xj, cj)), th["r"]):
        return
    tp = TTree(depth=3, num_thresholds=8, device=CPU).fit(
        None, torch.from_numpy(X), torch.from_numpy(ctr),
        torch.from_numpy(th["w"]), k)
    _assert_tied_split(X, ctr, th["w"], jp, tp, k)


def _assert_tied_split(X, ctr, w, jp, tp, k, depth=3, q=8):
    """Two trees fit on the same weights part at a node.  In float64 the
    port's split there scores no worse than the reference's, and either the
    two tie (within 1e-5 of the node's mass) or the reference's float32
    score of its own split lies below that split's exact score: rounding
    noise, such as the cancelling residues of an empty child, decided the
    reference's choice (the tree caveat of tests/test_torch_session.py).
    With every split equal, a leaf whose two classes carry the same mass
    parts them."""
    n = X.shape[0]
    X64, w64 = X.astype(np.float64), w.astype(np.float64)
    onehot = np.eye(k)[ctr]

    def gini(mask):
        h = (w64[mask, None] * onehot[mask]).sum(0)
        s = h.sum()
        return s - (h * h).sum() / max(s, 1e-12)

    jf, jt = np.asarray(jp["feat"]), np.asarray(jp["thr"])
    tf, tt = tp["feat"].numpy(), tp["thr"].numpy()
    node_of = np.zeros(n, np.int64)
    for level in range(depth):
        off = 2 ** level - 1
        for node in range(2 ** level):
            i = off + node
            if jf[i] == tf[i] and np.isclose(jt[i], tt[i], rtol=1e-6):
                continue
            sel = node_of == node
            ref, port = [gini(sel & (X64[:, f] <= t))
                         + gini(sel & (X64[:, f] > t))
                         for f, t in ((jf[i], jt[i]), (tf[i], tt[i]))]
            tol = 1e-5 * max(w64[sel].sum(), 1e-12)
            ref_f32 = reference_chosen_scores(
                jnp.asarray(X), jnp.asarray(ctr), jnp.asarray(w),
                depth=depth, q=q, k=k)[i]
            assert port <= ref + tol, (level, node, ref, port)
            assert abs(ref - port) <= tol or ref_f32 < ref - tol, \
                (level, node, ref, port, ref_f32)
            return
        f, t = jf[off + node_of], jt[off + node_of]
        node_of = 2 * node_of + (X64[np.arange(n), f] > t)
    jl, tl = np.asarray(jp["leaf"]), tp["leaf"].numpy()
    leaf = int(np.flatnonzero(jl != tl)[0])
    h = (w64[node_of == leaf, None] * onehot[node_of == leaf]).sum(0)
    assert abs(h[jl[leaf]] - h[tl[leaf]]) <= 1e-5 * max(h.sum(), 1e-12)


def _assert_on_a_boundary(jh, hop_draws):
    """At a parted hop: the port's codec, given the reference's own update,
    reproduces the reference's output exactly; and every element where the
    port's update rounds otherwise sits on a rounding boundary."""
    codec = jh["codec"]
    args = (jnp.asarray(jh["w"]), jnp.asarray(jh["r"]),
            jnp.float32(jh["alpha"]))
    ref_w = torch.from_numpy(np.array(jsc.ignorance_update(*args)))
    port_w = tops.ignorance_update(*(torch.from_numpy(np.array(a))
                                     for a in args))
    n = ref_w.shape[0]
    if isinstance(codec, jcodecs.QuantCodec):
        u = hop_draws.uniform((n,), CPU)
        ref_xhat, ref_q, ref_scale = tq.quantize_dequant_plain(
            ref_w, u, codec.qmax)
        assert torch.equal(ref_xhat, torch.from_numpy(jh["out"]))
        _, port_q, _ = tq.quantize_dequant_plain(port_w, u, codec.qmax)
        parted = port_q != ref_q
        assert parted.any() and (port_q - ref_q).abs().max() == 1
        v = ref_w[parted] / ref_scale + u[parted]   # the floor's argument
        assert float((v - v.round()).abs().max()) < 1e-3, v
    elif isinstance(codec, jcodecs.Fp16Codec):
        assert torch.equal(ref_w.half().float(), torch.from_numpy(jh["out"]))
        parted = port_w.half() != ref_w.half()
        assert parted.any()
        # a midpoint between two halves lies between the two updates
        lo = torch.minimum(port_w, ref_w)[parted].double()
        hi = torch.maximum(port_w, ref_w)[parted].double()
        a, b = ref_w.half()[parted].double(), port_w.half()[parted].double()
        mid = (a + b) / 2
        assert bool(((lo <= mid) & (mid <= hi)).all())
    else:
        raise AssertionError(f"a hop parted under {codec!r}")


def _assert_match(js, ts, jhops, thops, blob):
    Xtr, ctr, Xte, _, k = blob
    jc, tc = js.state.components, ts.state.components
    assert [(c.agent, c.round) for c in tc] == [(c.agent, c.round) for c in jc]
    assert (ts.state.round, ts.state.stopped, len(ts.state.history)) == \
        (js.state.round, js.state.stopped, len(js.state.history))
    assert ts.transport.log.entries == js.transport.log.entries
    assert len(thops) == len(jhops)
    assert [h["skipped"] for h in thops] == [h["skipped"] for h in jhops]
    split = _first_divergent_hop(jhops, thops, ts.draws, Xtr, ctr, k)
    upto = len(jhops) if split is None else split
    np.testing.assert_allclose([c.alpha for c in tc[:upto]],
                               [c.alpha for c in jc[:upto]], rtol=1e-5)
    for jh, th in zip(jhops[:upto], thops[:upto]):
        np.testing.assert_allclose(th["out"], jh["out"], rtol=0, atol=1e-6)
    Xte_j = [jnp.asarray(x) for x in Xte]
    Xte_t = [torch.from_numpy(x) for x in Xte]
    jp = np.asarray(js.predict_distributed(Xte_j))
    tp = ts.predict_distributed(Xte_t).numpy()
    assert ts.transport.log.entries == js.transport.log.entries
    if split is None:
        np.testing.assert_allclose(ts.state.w.numpy(), np.asarray(js.state.w),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(
            ts.fitted().predict(Xte_t).numpy(),
            np.asarray(js.fitted().predict(Xte_j)))
    return split


@pytest.mark.parametrize("name", sorted(CHANNELS))
def test_channel_session_matches_reference(blob, name):
    js, ts, jhops, thops = _run_pair(blob, name)
    _assert_match(js, ts, jhops, thops, blob)
    jt, tt = js.transport, ts.transport
    if jt.accountant is not None:
        assert tt.accountant.releases == jt.accountant.releases
        assert tt.accountant.report(tt.privacy) == \
            jt.accountant.report(jt.privacy)
    if name == "budget":
        assert tt.skipped == jt.skipped and tt.exhausted and jt.exhausted
        assert tt.link_spent == jt.link_spent
        rungs = {e["rung"] for e in tt.log.entries if "rung" in e}
        assert rungs == {0, 1, 2, 3}
        assert any(h["skipped"] for h in thops)
    if name == "topk":
        for agent, res in ts.state.codec_state.items():
            np.testing.assert_allclose(res.numpy(),
                                       np.asarray(js.state.codec_state[agent]),
                                       rtol=0, atol=1e-6)
    kinds = tt.log.bits_by_kind()
    hops = sum(not h["skipped"] for h in thops)
    n = len(blob[1])
    if name != "budget":
        want = (tt.codec.wire_bits(n) if tt.codec is not None else 32 * n)
        assert kinds["ignorance"] == hops * want


def test_budget_skip_keeps_the_stale_score_and_the_hop_index(blob):
    """A skipped hop still owns its draws: the hops after it take the
    reference's keys by position, and the receiver keeps its stale w."""
    js, ts, jhops, thops = _run_pair(blob, "budget", rounds=4)
    skipped = [h for h, rec in enumerate(thops) if rec["skipped"]]
    assert skipped and skipped == [h for h, rec in enumerate(jhops)
                                   if rec["skipped"]]
    for h in skipped:
        np.testing.assert_array_equal(thops[h]["out"], thops[h]["w"])
    # exhaustion stops scheduling at the next round's entry
    assert ts.state.stopped and ts.state.round == js.state.round
    assert ts.state.round < 4


# ============================================================ pause / resume
RESUME_CHANNELS = {
    "topk+dp": lambda n, m: T.MeteredTransport(
        codec=tcodecs.TopKCodec(), privacy=TMech(epsilon=1.0),
        accountant=TRDP()),
    "budget+dp": lambda n, m: TBudgeted(
        TBudgetSpec(session_bits=_budget_bits(n, m, (0, 1, 1, 2, 2, 3, 3))),
        privacy=TMech(epsilon=1.0)),
}


def _port_session(blob, transport, rounds=4):
    Xtr, ctr, _, _, k = blob
    return T.Protocol(T.SessionConfig(num_classes=k, max_rounds=rounds),
                      transport=transport, device=CPU).start(
        2, T.endpoints_for(_tlearners(len(Xtr)),
                           [torch.from_numpy(x) for x in Xtr]),
        torch.from_numpy(ctr))


@pytest.mark.parametrize("name", sorted(RESUME_CHANNELS))
def test_pause_and_resume_bit_exact(blob, tmp_path, name):
    """Top-k residuals, budget spend and DP release counts cross a
    checkpoint; the default draw source indexes draws by hop, so the
    resumed run is the uninterrupted one, bit for bit."""
    Xtr, ctr, Xte, _, k = blob
    m, n = len(Xtr), len(ctr)
    full = _port_session(blob, RESUME_CHANNELS[name](n, m))
    full.run()
    part = _port_session(blob, RESUME_CHANNELS[name](n, m))
    part.step()
    part.step()
    part.checkpoint(str(tmp_path))
    paused_bits = part.transport.total_bits
    resumed = T.Protocol(T.SessionConfig(num_classes=k, max_rounds=4),
                         transport=RESUME_CHANNELS[name](n, m),
                         device=CPU).resume(
        str(tmp_path), T.endpoints_for(_tlearners(m), [torch.from_numpy(x)
                                                    for x in Xtr]),
        torch.from_numpy(ctr))
    assert resumed.state.round == 2
    resumed.run()
    assert torch.equal(resumed.state.w, full.state.w)
    assert [(c.agent, c.round, c.alpha) for c in resumed.state.components] \
        == [(c.agent, c.round, c.alpha) for c in full.state.components]
    assert resumed.state.history == full.state.history
    ft, rt = full.transport, resumed.transport
    assert rt.accountant.releases == ft.accountant.releases
    assert paused_bits + rt.total_bits == ft.total_bits
    if name == "budget+dp":
        assert (rt.exhausted, rt.link_spent) == (ft.exhausted, ft.link_spent)
        assert ft.skipped[len(ft.skipped) - len(rt.skipped):] == rt.skipped
    else:
        assert resumed.state.codec_state.keys() == full.state.codec_state.keys()
        for a, res in full.state.codec_state.items():
            assert torch.equal(resumed.state.codec_state[a], res)
    Xte_t = [torch.from_numpy(x) for x in Xte]
    assert torch.equal(resumed.predict_distributed(Xte_t),
                       full.predict_distributed(Xte_t))


@pytest.mark.parametrize("name", ["topk+dp", "budget"])
def test_state_from_reference_resumes_a_channel_session(blob, tmp_path, name):
    """A reference session checkpointed mid-run with top-k and DP, or under
    a budget, is read by the port with numpy alone and resumed with the
    reference's draws; it ends where the reference's own run ends."""
    Xtr, ctr, Xte, _, k = blob
    m, n = len(Xtr), len(ctr)
    if name == "topk+dp":
        jt = J.MeteredTransport(codec=jcodecs.TopKCodec(),
                                privacy=JMech(epsilon=10.0))
        tt = T.MeteredTransport(codec=tcodecs.TopKCodec(),
                                privacy=TMech(epsilon=10.0))
    else:
        bits = _budget_bits(n, m, (0, 0, 0, 0, 0, 1, 2, 3))
        jt = JBudgeted(JBudgetSpec(session_bits=bits))
        tt = TBudgeted(TBudgetSpec(session_bits=bits))
    key = jax.random.key(2)
    cfg = dict(num_classes=k, max_rounds=4)
    ref = J.Protocol(J.SessionConfig(**cfg), transport=jt).start(
        key, J.endpoints_for(_jlearners(m), [jnp.asarray(x) for x in Xtr]),
        jnp.asarray(ctr))
    ref.step()
    ref.step()
    ref.checkpoint(str(tmp_path))
    entries_at_pause = len(jt.log.entries)
    jhops, thops = _record(jt), _record(tt)
    ref.run()
    state = state_from_reference(str(tmp_path), device=CPU)
    assert state.comm == json.loads(json.dumps(ref.state.comm))
    if name == "topk+dp":
        assert set(state.codec_state) == {f"agent{i}" for i in range(m)}
        assert state.comm == {"releases": {f"agent{i}": 2
                                           for i in range(m)}}
    draws = ReplayDraws(key, m)
    port = T.Protocol(T.SessionConfig(**cfg), transport=tt, device=CPU,
                      draws=draws)
    resumed = port.resume_state(state, T.endpoints_for(
        _tlearners(m), [torch.from_numpy(x) for x in Xtr]),
        torch.from_numpy(ctr))
    assert resumed.state.round == 2
    resumed.run()
    jc, tc = ref.state.components, resumed.state.components
    assert [(c.agent, c.round) for c in tc] == [(c.agent, c.round) for c in jc]
    assert tt.log.entries == jt.log.entries[entries_at_pause:]
    split = _first_divergent_hop(jhops, thops, draws, Xtr, ctr, k,
                                 first=2 * m)
    upto = 2 * m + (len(jhops) if split is None else split)
    np.testing.assert_allclose([c.alpha for c in tc[:upto]],
                               [c.alpha for c in jc[:upto]], rtol=1e-5)
    if split is None:
        np.testing.assert_allclose(resumed.state.w.numpy(),
                                   np.asarray(ref.state.w), rtol=0,
                                   atol=1e-6)
        draws.final_key = ref.state.key
        np.testing.assert_array_equal(
            resumed.predict_distributed([torch.from_numpy(x)
                                         for x in Xte]).numpy(),
            np.asarray(ref.predict_distributed([jnp.asarray(x)
                                                for x in Xte])))
    if name == "topk+dp":
        assert tt.accountant.releases == jt.accountant.releases
    else:
        assert (tt.exhausted, tt.link_spent, tt.skipped[-1]) == \
            (jt.exhausted, jt.link_spent, jt.skipped[-1])
        assert tt.carryover_bits == ref.state.comm["ledger_bits"]


# ====================================================================== CLI
def _cli(args, capsys):
    out = cli.run(cli.parser().parse_args(["--device", CPU, "--n", "300",
                                           "--rounds", "3", *args]))
    return out, capsys.readouterr().out.splitlines()


def test_cli_prints_the_channel_lines(capsys):
    run, lines = _cli(["--codec", "int4", "--serve-codec", "int8",
                       "--dp-epsilon", "1", "--accountant", "rdp"], capsys)
    n = run.session.state.w.shape[0]
    hops = len(run.session.state.components)
    codec = tcodecs.QuantCodec(bits=4)
    assert f"codec=QuantCodec,ignorance_bits={hops * codec.wire_bits(n)}" \
        in lines
    assert "serve_codec=QuantCodec" in lines
    serve = [x for x in lines if x.startswith("serve: acc=")]
    block = (300 - n, run.session.cfg.num_classes)
    assert serve and serve[0].endswith(
        f",score_block_bits="
        f"{3 * tcodecs.QuantCodec(bits=8).wire_bits(block)}")
    dp = [x for x in lines if x.startswith("dp: ")]
    assert dp and '"epsilon_additive"' in dp[0] and '"rdp_order"' in dp[0]

    run, lines = _cli(["--byte-budget", str(_budget_bits(n, 4) // 8)],
                      capsys)
    budget = [x for x in lines if x.startswith("budget: ")]
    t = run.transport
    assert budget == [f"budget: spent={t.total_bits}b,skipped_hops="
                      f"{len(t.skipped)},exhausted=True"]
    assert [x for x in lines if x.startswith("serve: ")][0].endswith(
        f",skipped_hops={len(t.skipped)}")


@pytest.mark.parametrize("bad", [
    ["--byte-budget", "100", "--codec", "int8"],
    ["--byte-budget", "100", "--serve-codec", "int8"],
    ["--byte-budget", "100", "--transport", "inprocess"],
    ["--accountant", "rdp"],
])
def test_cli_applies_the_reference_argument_rules(bad, capsys):
    with pytest.raises(SystemExit):
        _cli(bad, capsys)


def test_cli_pauses_and_resumes_a_channel_session(tmp_path, capsys):
    base = ["--codec", "topk", "--dp-epsilon", "1"]
    full, _ = _cli(base, capsys)
    ckpt = ["--ckpt-dir", str(tmp_path)]
    paused, _ = _cli(base + ckpt + ["--stop-after", "2"], capsys)
    assert paused.paused
    resumed, _ = _cli(base + ckpt + ["--resume"], capsys)
    assert torch.equal(resumed.session.state.w, full.session.state.w)
    assert resumed.transport.accountant.releases == \
        full.transport.accountant.releases
    with pytest.raises(SystemExit):           # another codec: a mismatch
        _cli(["--codec", "int8", "--dp-epsilon", "1"] + ckpt + ["--resume"],
             capsys)


# ================================================================ the card
@pytest.mark.gpu
def test_quantize_kernels_match_plain_on_card():
    """The four CUDA kernels against their plain versions on the card
    (skips without one): q, scales and bytes exact, xhat equal, two runs
    identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in ((1,), (420,), (1024,), (10500,), (42000,), (2 ** 20 + 3,),
                  (4500, 2), (18000, 10), (2040, 10), (3069, 3)):
        x = torch.rand(shape, generator=gen, device=dev) - 0.3
        u = torch.rand(shape, generator=gen, device=dev)
        fn = tops.quantize_dequant_block if len(shape) == 2 \
            else tops.quantize_dequant
        plain = tq.quantize_dequant_block_plain if len(shape) == 2 \
            else tq.quantize_dequant_plain
        for qmax in (127.0, 7.0):
            got = fn(x, u, qmax)
            want = plain(x, u, qmax)
            assert torch.equal(got[1], want[1]), shape
            assert torch.equal(got[2], want[2]), shape
            assert torch.equal(got[0], want[0]), shape
            again = fn(x, u, qmax)
            assert all(torch.equal(a, b) for a, b in zip(again, got))
    for m in (1, 2, 21001, 42000, 2 ** 20 + 1):
        q = torch.randint(-8, 8, (m,), generator=gen, device=dev,
                          dtype=torch.int8)
        packed = tops.pack_int4(q)
        assert torch.equal(packed, tq.pack_int4_plain(q))
        assert torch.equal(tops.unpack_int4(packed, m), q)
        assert torch.equal(tq.unpack_int4_plain(packed, m), q)


@pytest.mark.gpu
def test_fashion_int8_session_tracks_reference_on_card():
    """Full width (Fashion surrogate: 42000 training rows, 2 x 392 pixels,
    10 classes, 5 rounds of 300-step logistic agents), fp32 and
    ``--codec int8``: the port on the card, fed the reference's draws,
    against the reference (JAX, on the host).  The ledgers are equal
    exactly, the accuracies within 0.01 (skips without a card).  With
    int8 both lose much of the fp32 accuracy at this width: the global
    tile zeroes most easy samples' weights and capped alphas follow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro.learners.logistic import LogisticRegression as JLogistic
    from repro_torch.data.partition import train_test_split as t_split
    from repro_torch.data.partition import vertical_split as t_vsplit
    from repro_torch.data.synthetic import fashion_surrogate
    from repro_torch.learners.logistic import LogisticRegression as TLogistic
    ds = fashion_surrogate(torch.Generator().manual_seed(0), n=60000,
                           device=CPU)
    tr, te = t_split(0, 60000)
    Xs = t_vsplit(ds.X, ds.splits)
    Xtr = [x[torch.as_tensor(tr)].numpy() for x in Xs]
    Xte = [x[torch.as_tensor(te)].numpy() for x in Xs]
    ctr = ds.classes[torch.as_tensor(tr)].numpy()
    cte = ds.classes[torch.as_tensor(te)].numpy()
    key = jax.random.key(0)
    for codec in ("fp32", "int8"):
        jt = J.MeteredTransport(codec=jcodecs.make_codec(codec))
        tt = T.MeteredTransport(codec=tcodecs.make_codec(codec))
        js = J.Protocol(J.SessionConfig(num_classes=10, max_rounds=5),
                        transport=jt).start(
            key, J.endpoints_for([JLogistic(steps=300)] * 2,
                                 [jnp.asarray(x) for x in Xtr]),
            jnp.asarray(ctr))
        js.run()
        ts = T.Protocol(T.SessionConfig(num_classes=10, max_rounds=5),
                        transport=tt, device="cuda",
                        draws=ReplayDraws(key, 2)).start(
            0, T.endpoints_for([TLogistic(steps=300, device="cuda")] * 2,
                               [torch.from_numpy(x).cuda() for x in Xtr]),
            torch.from_numpy(ctr).cuda())
        ts.run()
        j_acc = float(np.mean(np.asarray(js.fitted().predict(
            [jnp.asarray(x) for x in Xte])) == cte))
        t_acc = float((ts.fitted().predict(
            [torch.from_numpy(x).cuda() for x in Xte]).cpu().numpy()
            == cte).mean())
        print(f"fashion {codec}: reference acc {j_acc:.4f} alphas "
              f"{[round(c.alpha, 3) for c in js.state.components]}; port "
              f"(card) acc {t_acc:.4f} alphas "
              f"{[round(c.alpha, 3) for c in ts.state.components]}")
        assert tt.log.entries == jt.log.entries
        assert abs(t_acc - j_acc) <= 0.01

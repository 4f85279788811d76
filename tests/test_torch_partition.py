"""The port's non-IID partitioners against the JAX package's: the same
seeds give the reference's index arrays exactly (both are numpy on a
seeded ``default_rng``), over a grid of seeds, agent counts and skews,
extreme skews that starve a shard (``_rebalance_empties``) included; and
the reference's properties of tests/test_partition_props.py: every row in
exactly one shard, every shard nonempty, the quantity spread growing
strictly with the skew."""
import numpy as np
import pytest

from repro.data import partition as J
from repro_torch.data import partition as T


def _classes(seed, n, k):
    return np.random.default_rng(100 + seed).integers(0, k, size=n)


def _assert_same(js, ts):
    assert len(ts) == len(js)
    for a, b in zip(js, ts):
        assert b.dtype == np.int64
        np.testing.assert_array_equal(b, a)


def _assert_cover(shards, n):
    rows = np.concatenate(shards)
    np.testing.assert_array_equal(np.sort(rows), np.arange(n))
    if n >= len(shards):
        assert all(len(s) > 0 for s in shards)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("agents", [1, 3, 8])
@pytest.mark.parametrize("alpha", [0.05, 0.3, 5.0])
def test_dirichlet_equals_reference(seed, agents, alpha):
    classes = _classes(seed, 150, 6)
    js = J.dirichlet_label_partition(seed, classes, agents, alpha=alpha)
    ts = T.dirichlet_label_partition(seed, classes, agents, alpha=alpha)
    _assert_same(js, ts)
    _assert_cover(ts, 150)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("agents", [1, 4, 9])
@pytest.mark.parametrize("skew", [0.0, 0.5, 2.0])
def test_quantity_equals_reference(seed, agents, skew):
    js = J.quantity_partition(seed, 103, agents, skew=skew)
    ts = T.quantity_partition(seed, 103, agents, skew=skew)
    _assert_same(js, ts)
    _assert_cover(ts, 103)
    np.testing.assert_array_equal(T.quantity_proportions(agents, skew),
                                  J.quantity_proportions(agents, skew))


@pytest.mark.parametrize("case", ["quantity", "dirichlet"])
def test_extreme_skew_rebalances_empty_shards(case):
    """A skew that leaves shards empty before the rebalance: each empty
    shard takes a row from the largest, as the reference's does."""
    n, agents = 12, 6
    if case == "quantity":
        raw = T.quantity_proportions(agents, 8.0) * n
        assert (np.floor(raw) == 0).sum() >= 2      # starved before
        js = J.quantity_partition(3, n, agents, skew=8.0)
        ts = T.quantity_partition(3, n, agents, skew=8.0)
    else:
        classes = _classes(3, n, 2)
        js = J.dirichlet_label_partition(3, classes, agents, alpha=0.01)
        ts = T.dirichlet_label_partition(3, classes, agents, alpha=0.01)
    _assert_same(js, ts)
    _assert_cover(ts, n)


def test_rebalance_empties_equals_reference():
    shards = [[5, 1, 9, 2], [], [3], [], [0, 4, 6, 7, 8]]
    _assert_same(J._rebalance_empties([list(s) for s in shards]),
                 T._rebalance_empties([list(s) for s in shards]))


def test_quantity_spread_grows_with_skew():
    spreads = []
    for skew in (0.0, 0.25, 0.5, 1.0, 2.0, 4.0):
        p = T.quantity_proportions(6, skew)
        assert abs(p.sum() - 1.0) < 1e-12
        spreads.append(p.max() / p.min())
        np.testing.assert_allclose(spreads[-1], 6 ** skew, rtol=1e-12)
    assert all(b > a for a, b in zip(spreads, spreads[1:]))


def test_partitioners_reject_what_the_reference_rejects():
    for fn, args in ((T.dirichlet_label_partition, (0, [0, 1], 2, 0.0)),
                     (T.dirichlet_label_partition, (0, [0, 1], 0, 0.5)),
                     (T.quantity_proportions, (3, -1.0)),
                     (T.quantity_partition, (0, 10, 0, 1.0))):
        with pytest.raises(ValueError):
            fn(*args)

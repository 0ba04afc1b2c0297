"""The traffic generator: one seed gives the same calls, two seeds give
other orders of the same work, rounds hold the same sizes, and each
round's first call is greedy and holds its longest request."""
import itertools

import numpy as np
import pytest

from benchmark import harness, traffic

CELLS = ["wn_moon.vocode_b8", "wn_moon.vocode_b1"]


def take(cell, seed, n):
    params = harness.load_workload(cell)["traffic"]
    sources = [np.arange(40 * 80, dtype=np.float32).reshape(40, 80) + k
               for k in range(len(params["sources"]))]
    return params, list(itertools.islice(
        traffic.calls(params, seed, sources), n))


def flat(calls):
    return [(c.greedy, c.seed, [(r.size, r.mel.tobytes())
                                for r in c.requests]) for c in calls]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_calls(cell):
    _, a = take(cell, 2 ** 31 + 7, 20)
    _, b = take(cell, 2 ** 31 + 7, 20)
    assert flat(a) == flat(b)


@pytest.mark.parametrize("cell", CELLS)
def test_other_seed_other_order_same_work(cell):
    params, a = take(cell, 11, 40)
    _, b = take(cell, 12, 40)
    assert flat(a) != flat(b)
    per_round = params["per_round"] // params["batch"]
    sizes = lambda calls: sorted(r.size for c in calls[:per_round]
                                 for r in c.requests)
    assert sizes(a) == sizes(b)
    assert sizes(a) == sizes(a[per_round:2 * per_round])


@pytest.mark.parametrize("cell", CELLS)
def test_round_starts_greedy_with_its_longest(cell):
    params, calls = take(cell, 5, 30)
    per_round = params["per_round"] // params["batch"]
    lo, hi = params["frames"]
    for start in range(0, 30 - per_round + 1, per_round):
        rnd = calls[start:start + per_round]
        assert rnd[0].greedy
        assert max(r.size for r in rnd[0].requests) == hi
        assert all(lo <= r.size <= hi for c in rnd for r in c.requests)
        assert [c.greedy for c in rnd] == [
            i % params["greedy_every"] == 0 for i in range(per_round)]


def test_contents_cut_or_repeated_from_the_sources():
    _, calls = take("wn_moon.vocode_b8", 3, 8)
    for c in calls:
        for r in c.requests:
            assert r.mel.shape == (r.size, 80)
            # rows are consecutive source rows, wrapping at the source's end
            rows = (r.mel[:, 0] % (40 * 80)) // 80
            assert np.all(np.diff(rows) % 40 == 1)

"""The traffic generator: deterministic from the seed, and what it draws
is what the traffic file asks for, the distribution's tail included."""
import numpy as np
import pytest

from perfbench import gen, harness

MIX = "chat-closed64"


def test_requests_repeat_from_the_seed():
    m = harness.traffic(MIX)
    a, b = gen.Requests(m, 1000, 2**40 + 3), gen.Requests(m, 1000, 2**40 + 3)
    for _ in range(70):
        (pa, na), (pb, nb) = a.next(), b.next()
        assert na == nb and np.array_equal(pa, pb)
    c = gen.Requests(m, 1000, 2**40 + 4)
    assert any(not np.array_equal(a.next()[0], c.next()[0]) for _ in range(5))


def _blocks(m, seed, count):
    """The first client cohort, then ``count`` blocks of sizes, each
    sorted."""
    r = gen.Requests(m, 50, seed)
    first = sorted(r.next()[1] for _ in range(m["clients"]))
    n = m["block"]
    draws = [r.next() for _ in range(count * n)]
    return first, [(sorted(len(p) for p, _ in draws[k * n:(k + 1) * n]),
                    sorted(o for _, o in draws[k * n:(k + 1) * n]))
                   for k in range(count)]


def test_every_seed_sends_the_same_blocks_within_the_file_bounds():
    m = harness.traffic(MIX)
    first, blocks = _blocks(m, 1, 16)
    assert (first, blocks) == _blocks(m, 2**33 + 7, 16)
    for key, i in (("prompt", 0), ("output", 1)):
        spec = m[key]
        vals = [v for b in blocks for v in b[i]]
        assert spec["min"] <= min(vals) and max(vals) <= spec["max"]
        assert abs(np.median(vals) - spec["median"]) <= 0.05 * spec["median"]
        # block b's grid is offset by the radical inverse of b + 1: the
        # 15th block reaches the 0.996 quantile
        assert max(vals) == gen.quantiles(spec, m["block"], 15 / 16)[-1]
        assert max(vals) > 3.5 * spec["median"]


def test_the_first_cohort_is_the_steady_state_residual():
    """A client met at a random time in the steady state has, on average,
    E[L^2] / (2 E[L]) output tokens still to come, more than E[L] / 2 for
    a wide length distribution (the inspection paradox)."""
    m = harness.traffic(MIX)
    spec = m["output"]
    first, _ = _blocks(m, 5, 0)
    assert first == sorted(gen.residuals(spec, m["clients"]).tolist())
    t = gen.tail(spec)
    r = np.arange(len(t))
    mean_l = t[1:].sum()
    pl = t - np.append(t[1:], 0.0)
    want = (pl * r * (r + 1)).sum() / (2 * mean_l)
    assert abs(np.mean(first) - want) < 0.05 * want
    assert np.mean(first) > 0.8 * mean_l
    assert 1 <= min(first) and max(first) <= spec["max"]


def test_tail_matches_the_stratified_draws():
    spec = harness.traffic(MIX)["output"]
    vals = gen.quantiles(spec, 4096)
    t = gen.tail(spec)
    for r in (spec["min"], 50, 129, 500, 1500):
        assert abs(np.mean(vals >= r) - t[r]) < 2e-3


def test_radical_inverse():
    assert [gen.radical_inverse(k) for k in range(1, 8)] == [
        0.5, 0.25, 0.75, 0.125, 0.625, 0.375, 0.875]


def test_fixed_lengths():
    assert list(gen.quantiles({"dist": "fixed", "value": 5}, 3)) == [5, 5, 5]
    with pytest.raises(ValueError):
        gen.quantiles({"dist": "zipf"}, 3)

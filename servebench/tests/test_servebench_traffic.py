"""The traffic generator: deterministic for a seed, the same lengths for
every seed in another order, and the laws of the traffic files."""
import collections
import itertools
import math
from statistics import NormalDist

import pytest

from servebench.core import spec, traffic
from servebench.tests.tiny import CELLS


def _calls(name, seed, n):
    c = spec.load_cell(name)
    return list(itertools.islice(traffic.calls(c.traffic, c.prefix, seed),
                                 n))


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_calls(name):
    assert _calls(name, 2**31 + 5, 40) == _calls(name, 2**31 + 5, 40)


@pytest.mark.parametrize("name", CELLS)
def test_every_seed_serves_the_same_lengths_in_another_order(name):
    c = spec.load_cell(name)
    k = c.traffic["per_pass"]
    passes = {}
    for seed in (0, 1, 2**31 + 1, 2**40 + 3):
        got = _calls(name, seed, 3 * k)
        for p in range(3):
            chunk = got[p * k:(p + 1) * k]
            assert sorted(x.text for x in chunk) == \
                traffic.text_lengths(c.traffic, c.prefix)
            assert [x.index for x in chunk] == list(range(p * k, (p + 1) * k))
        passes[seed] = [x.text for x in got[:k]]
    assert len({tuple(v) for v in passes.values()}) > 1


def test_longdoc_law_is_uniform_over_its_positions():
    c = spec.load_cell("llava.longdoc")
    got = [x.positions for x in _calls("llava.longdoc", 9, 4 * 25)]
    assert collections.Counter(got) == {8192: 25, 16384: 25, 24576: 25,
                                        32768: 25}
    assert all(x.prefix == 576 and x.rows == 1
               for x in _calls("llava.longdoc", 9, 8))
    assert c.traffic["measures"] == "positions"


@pytest.mark.parametrize("name,mu,sigma,lo,hi,rows", [
    ("llava.chat", 7.7, 0.55, 256, 16384, 1)])
def test_lognormal_laws_are_the_repos_prompt_laws(name, mu, sigma, lo, hi,
                                                  rows):
    c = spec.load_cell(name)
    law = c.traffic["law"]
    assert (law["mu"], law["sigma"], law["low"], law["high"]) == \
        (mu, sigma, lo, hi)
    assert c.traffic["rows"] == rows and c.traffic["measures"] == "text"
    lengths = traffic.pass_lengths(c.traffic)
    k = len(lengths)
    for i, n in enumerate(lengths):
        q = NormalDist(mu, sigma).inv_cdf((i + 0.5) / k)
        assert n == int(min(max(math.exp(q), lo), hi))
    assert lengths == sorted(lengths)
    # the median of the law lies between the two middle quantiles
    assert lengths[k // 2 - 1] <= math.exp(mu) <= lengths[k // 2]

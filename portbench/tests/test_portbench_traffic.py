"""Each mix is deterministic per seed, and seeds reorder the same work."""

import collections

import pytest

from portbench.generator import Mix, arrivals, index_of

MIXES = ["ftw-replay", "browse", "bodies"]

# A mix of bodies only (JSON and form, log-normal lengths, payloads in the
# body), as a data file would give it: the generator's body path.
BODIES = {"post_share": 1.0, "attack_share": 0.1, "attack_in": "body", "post_bodies": ["json", "form"],
          "body_bytes": {"median": 2048, "sigma": 0.7, "min": 1024, "max": 16384},
          "attack_values": ["1' UNION SELECT password FROM users--", "<script>alert(1)</script>"],
          "words": ["alpha", "beta", "gamma", "delta", "order", "item"]}


def _mix(name: str, seed: int) -> Mix:
    if name != "bodies":
        return Mix(name, seed)
    m = Mix("browse", seed)
    m.name, m.params = "bodies", dict(m.params, **BODIES)
    return m


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a, b = _mix(mix, 2**31 + 5), _mix(mix, 2**31 + 5)
    assert [a.request(i) for i in range(250)] == [b.request(i) for i in range(250)]
    assert all(index_of(a.request(i).uri) == i for i in range(250))


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_reorder_the_same_work(mix):
    a, b = _mix(mix, 11), _mix(mix, 12)
    n = a.block
    ra, rb = [a.request(i) for i in range(n)], [b.request(i) for i in range(n)]
    assert ra != rb
    assert collections.Counter(r.method for r in ra) == collections.Counter(r.method for r in rb)
    assert sorted(len(r.body) for r in ra) == sorted(len(r.body) for r in rb) or mix != "ftw-replay"


def test_arrivals_are_seeded_poisson_quantiles():
    a = arrivals(150.0, 7, 0, 2000)
    assert a == arrivals(150.0, 7, 0, 2000)
    assert a[1000:1005] == arrivals(150.0, 7, 1000, 5)
    rate = 999 / (a[999] - a[0])
    assert 140 < rate < 160
    other = arrivals(150.0, 8, 0, 1001)
    gaps = sorted(round(y - x, 9) for x, y in zip(a[:1000], a[1:1001]))
    assert gaps == sorted(round(y - x, 9) for x, y in zip(other[:1000], other[1:]))

"""The order in which ``pytest -n 6 --dist loadfile`` hands out the test
files: by collected item count, largest first, ties in collection order
(pytest-xdist's ``LoadScopeScheduling``).  ``tests/test_sharding.py`` is
the suite's longest file, so the suite's wall is its start plus its own
time: no port file may queue ahead of it by holding more items, and at
most the seven files that hold more items than it, or as many and come
first in collection order, may go before it."""

import collections

import pytest

SHARDING = "tests/test_sharding.py"
# its place in the order, counted from 1
LATEST_PLACE = 8


def test_no_port_file_queues_ahead_of_the_sharding_tests(request):
    counts = collections.Counter(
        item.nodeid.split("::", 1)[0] for item in request.session.items)
    if SHARDING not in counts:
        pytest.skip(f"{SHARDING} is not collected in this run")
    limit = counts[SHARDING]
    over = {f: n for f, n in counts.items()
            if f.startswith("tests/test_torch_") and n > limit}
    assert not over, (f"port test files with more than {SHARDING}'s {limit} "
                      f"items, which xdist hands out before it: {over}")
    order = sorted(counts, key=lambda f: -counts[f])  # stable: ties keep
    place = order.index(SHARDING) + 1                 # collection order
    assert place <= LATEST_PLACE, (
        f"{SHARDING} is handed out {place}th, after "
        f"{[(f, counts[f]) for f in order[:place - 1]]}")

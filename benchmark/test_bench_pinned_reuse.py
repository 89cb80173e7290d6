"""The reader of serve.copy_pinned_reuse on recorded calls' counters: the
share of calls that allocated no page-locked block, nothing where the
program does not count them."""

import pytest

from benchmark import run

READER = run.load_reader("serve.copy_pinned_reuse")


def _calls(*allocs):
    return [{"spans": [], "counters": {"serve.copy_back_bytes": 64,
                                       **({} if n is None else {"serve.copy.host_allocs": n})}}
            for n in allocs]


@pytest.mark.parametrize("allocs,want", [((0, 0, 1, 0), 75.0), ((0,), 100.0),
                                         ((3, 1), 0.0), ((None, None), None)])
def test_share_of_calls_without_an_allocation(allocs, want):
    assert READER.read({"spans": _calls(*allocs)}) == want


@pytest.mark.parametrize("spans", [None, []])
def test_no_recorded_calls_read_nothing(spans):
    assert READER.read({"spans": spans}) is None

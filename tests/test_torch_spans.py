"""The span recorder (pangenome_index_tpu_torch/spans.py) on the serving
path: nothing recorded, no event and no profiler annotation with recording
off; the span tree of a served call with it on; the spans in a profiler's
trace. It imports the port only (no JAX): the card's case runs on the card
with python -m pytest --noconftest tests/test_torch_spans.py -q."""

import json

import numpy as np
import pytest
import torch

from pangenome_index_tpu_torch import serve, spans
from pangenome_index_tpu_torch.ops import mems
from pangenome_index_tpu_torch.ops.fmd import rank_args
from pangenome_index_tpu_torch.ops.mems import find_mems, resident_lanes
from pangenome_index_tpu_torch.utils.alphabet import BYTE_TO_CODE
from pangenome_index_tpu_torch.utils.synth import (build_synth_index, synth_reads,
                                                   synth_tag_array)

#: the spans of one served call: name -> its parent's name
TREE = {"serve.run": None, "mems.find": "serve.run", "mems.resolve_seeds": "mems.find",
        "mems.k3": "mems.find", "tags.k4": "serve.run", "serve.wait": "serve.run",
        "serve.fetch": "serve.run",
        **{f"serve.copy.{f}": "serve.fetch" for f in serve.FETCHED}}
DEVICE_SPANS = {"mems.find", "mems.resolve_seeds", "mems.k3", "tags.k4",
                *(f"serve.copy.{f}" for f in serve.FETCHED)}
RUN_KW = dict(min_len=20, min_occ=1, capacity=8, tag_capacity=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: intra-op threads only contend with the
    other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def index():
    idx, lines = build_synth_index(6000, 3, seed=5)
    reads = synth_reads(lines, 16, 60, error_rate=0.01, seed=3)
    codes = np.stack([BYTE_TO_CODE[np.frombuffer(r, np.uint8)] for r in reads]).astype(np.int32)
    lens = np.full(len(reads), 60, np.int32)
    return idx, synth_tag_array(idx), codes, lens


def _batch(index, device):
    idx, tags, codes, lens = index
    return serve.prepare(idx, tags, codes, lens, device, mer_m=5, sdict_s=11)


@pytest.fixture(scope="module")
def batch(index):
    return _batch(index, "cpu")


def _arrays(res):
    return [getattr(res, f) for f in serve.FETCHED]


def _record(batch, device, calls=1):
    with spans.recording(device) as rec:
        results = [serve.run(batch, **RUN_KW) for _ in range(calls)]
    return rec, results


def _k3_counters(batch, cuda):
    """The mems.k3.* counters of one call on `batch`: from a with_stats call
    beside it; the resident lanes the occupancy API's on a card, the batch's
    reads in the plain version (its lockstep advances them all at once)."""
    _, stats = find_mems(batch.tables, batch.codes, batch.lengths, RUN_KW["min_len"],
                         RUN_KW["min_occ"], capacity=RUN_KW["capacity"], with_stats=True,
                         **batch.seed_kw)
    steps = stats["steps"].long()
    want = {"mems.k3.lanes": len(batch.lengths), "mems.k3.bases": int(batch.lengths.sum()),
            "mems.k3.steps": int(steps.sum()), "mems.k3.max_steps": int(steps.max()),
            "mems.k3.resident_lanes": len(batch.lengths)}
    if cuda:
        kind, _ = rank_args(batch.tables)
        want["mems.k3.resident_lanes"] = resident_lanes(kind, batch.codes.device)
    return want


def _check_tree(rec, res, batch):
    got = rec.spans
    assert sorted(s.name for s in got) == sorted(TREE)
    assert {s.call for s in got} == {0}
    by_name = {s.name: s for s in got}
    for s in got:
        parent = got[s.parent] if s.parent is not None else None
        assert (parent.name if parent else None) == TREE[s.name]
        assert s.host[0] <= s.host[1]
        if parent is not None:
            assert parent.host[0] <= s.host[0] and s.host[1] <= parent.host[1]
        assert (s.device is not None) == (s.name in DEVICE_SPANS)
    fetch = by_name["serve.fetch"]
    assert (fetch.host[1] - fetch.host[0]) * 1e-9 == res.seconds["fetch"]
    # every byte copied back lands in page-locked memory on a card, none on
    # the CPU; a warm call draws every page-locked block from the cache
    nbytes = sum(a.nbytes for a in _arrays(res))
    assert rec.counters == {"serve.copy_back_bytes": nbytes,
                            "serve.copy_back_pinned_bytes": nbytes if rec.cuda else 0,
                            "serve.copy.host_allocs": 0, **_k3_counters(batch, rec.cuda)}
    return by_name


def test_recording_off_records_nothing(batch, monkeypatch):
    want = serve.run(batch, **RUN_KW)

    def refuse(*args, **kwargs):
        raise AssertionError("called with recording off and no profiler")

    syncs = []
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "host_memory_stats", refuse)
    monkeypatch.setattr(mems, "count_k3", refuse)
    monkeypatch.setattr(serve, "_sync", lambda device: syncs.append(device))
    got = serve.run(batch, **RUN_KW)
    assert syncs == [batch.codes.device]
    assert spans._active is None
    for a, b in zip(_arrays(got), _arrays(want)):
        np.testing.assert_array_equal(a, b)
    assert set(got.seconds) == {"tables", "mer_table", "sdict", "windows", "upload", "fetch"}


def test_one_call_gives_the_span_tree(batch):
    rec, (res,) = _record(batch, "cpu")
    by_name = _check_tree(rec, res, batch)
    for name in DEVICE_SPANS:  # on the CPU the device interval is the host's
        assert by_name[name].device == tuple(float(t) for t in by_name[name].host)
    for a, b in zip(_arrays(res), _arrays(serve.run(batch, **RUN_KW))):
        np.testing.assert_array_equal(a, b)


def test_two_calls_give_two_call_ids(batch):
    rec, results = _record(batch, "cpu", calls=2)
    roots = [s for s in rec.spans if s.name == "serve.run"]
    assert [s.call for s in roots] == [0, 1]
    assert sorted({s.call for s in rec.spans}) == [0, 1]
    assert rec.counters["serve.copy_back_bytes"] == sum(
        a.nbytes for r in results for a in _arrays(r))


K3_COUNTERS = ("mems.k3.lanes", "mems.k3.bases", "mems.k3.steps", "mems.k3.max_steps",
               "mems.k3.resident_lanes")


def test_k3_counters_while_recording_only(batch):
    """The mems.k3.* counters of two recorded calls are twice one call's, the
    steps those of a with_stats call on the same batch; the plain version's
    resident lanes its reads; a call outside a recording leaves them out of
    it."""
    want = _k3_counters(batch, False)
    rec, _ = _record(batch, "cpu", calls=2)
    assert {k: v for k, v in rec.counters.items() if k.startswith("mems.")} == {
        k: 2 * v for k, v in want.items()}
    with spans.recording("cpu") as rec:
        serve.run(batch, **RUN_KW)
    serve.run(batch, **RUN_KW)
    assert {k: rec.counters[k] for k in K3_COUNTERS} == want


def test_k3_counters_wait_for_the_call(batch, monkeypatch):
    """A recorded call reads no K3 counter back before its one wait: at
    serve.wait the steps and bases are still held unreduced, and they are
    reduced once rec.counters is read, after the call."""
    at_wait = []
    monkeypatch.setattr(serve, "_sync", lambda device: at_wait.append(
        [name for name, *_ in spans._active._later]))
    with spans.recording("cpu") as rec:
        serve.run(batch, **RUN_KW)
        assert at_wait == [["mems.k3.bases", "mems.k3.steps", "mems.k3.max_steps"]]
        assert len(rec._later) == 3
    assert set(K3_COUNTERS) <= set(rec.counters) and rec._later == []


def test_count_later():
    """A "sum" counter adds every tensor's sum; a "max" counter keeps each
    served call's largest value, however many tensors the call counts and
    whenever the counters are read, and sums the calls' maxima; outside a
    recording nothing is kept."""
    t, u = torch.tensor([3, 9, 4]), torch.tensor([7, 1])
    spans.count_later("x", t, "max")
    with spans.recording("cpu") as rec:
        with spans.span("serve.run", call=True):
            spans.count_later("x", t, "max")
            spans.count_later("x", u, "max")
            spans.count_later("y", t, "sum")
        assert rec.counters == {"x": 9, "y": 16}
        with spans.span("serve.run", call=True):
            with spans.span("mems.find"):
                spans.count_later("x", u, "max")
            assert rec.counters == {"x": 16, "y": 16}  # read inside the call
            spans.count_later("x", t, "max")
            spans.count_later("x", u, "max")
            spans.count_later("y", u, "sum")
        with pytest.raises(ValueError):
            spans.count_later("z", t, "mean")
    assert rec.counters == {"x": 18, "y": 24}


def test_calls_own_their_arrays(batch):
    """Each call's arrays own their memory: no array of the first of three
    calls on one batch shares memory with the later calls' arrays, and the
    first call's arrays still hold what they held right after it."""
    first = serve.run(batch, **RUN_KW)
    kept = [a.copy() for a in _arrays(first)]
    later = [serve.run(batch, **RUN_KW) for _ in range(2)]
    for a in _arrays(first):
        for res in later:
            assert not any(np.shares_memory(a, b) for b in _arrays(res))
    for a, b in zip(_arrays(first), kept):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_spans_outside_a_recording_and_nested_recordings():
    sec = {}
    with spans.span("prepare.x", into=sec, key="x"):
        pass
    assert sec["x"] >= 0
    spans.count("nothing", 1)
    with spans.recording("cpu") as rec:
        with spans.span("a"):
            spans.count("n", 2)
            spans.count("n", 3)
        with pytest.raises(RuntimeError):
            with spans.recording("cpu"):
                pass
    assert [(s.name, s.call, s.parent) for s in rec.spans] == [("a", None, None)]
    assert rec.counters == {"n": 5}
    assert spans._active is None


def test_profiler_trace_holds_the_spans(batch, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        serve.run(batch, **RUN_KW)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    names = [e["name"] for e in events]
    assert sorted(names) == sorted(TREE)
    root = events[names.index("serve.run")]
    for e in events:
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"]


@pytest.mark.cuda
def test_device_intervals_on_the_card(index):
    """Device intervals in the order the work was enqueued, the kernels'
    before the call's wait ends, the copies' after the kernels', all on the
    calibrated clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = _batch(index, torch.device("cuda", 0))
    serve.run(b, **RUN_KW)
    rec, (res,) = _record(b, torch.device("cuda", 0))
    by_name = _check_tree(rec, res, b)
    dev = {k: s.device for k, s in by_name.items() if s.device is not None}
    wait_end = by_name["serve.wait"].host[1]
    order = ["mems.resolve_seeds", "mems.k3", "tags.k4",
             *(f"serve.copy.{f}" for f in serve.FETCHED)]
    for a, b_ in zip(order, order[1:]):
        assert dev[a][0] <= dev[a][1] <= dev[b_][0], (a, b_)
    for name in ("mems.find", "mems.resolve_seeds", "mems.k3", "tags.k4"):
        assert dev[name][1] <= wait_end, name
    find = dev["mems.find"]
    assert find[0] <= dev["mems.resolve_seeds"][0] and dev["mems.k3"][1] <= find[1]


@pytest.mark.cuda
def test_recorded_call_waits_once_on_the_card(index, monkeypatch):
    """On a card a recorded call reads nothing back from the device before
    its one wait: no synchronize, no item, tolist, int, bool or cpu of a
    tensor inside serve.run before serve.wait's synchronize (the K3
    counters are reduced when rec.counters is read)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    b = _batch(index, dev)
    serve.run(b, **RUN_KW)
    seen = []

    def noted(what, orig):
        def call(*args, **kwargs):
            seen.append(what)
            return orig(*args, **kwargs)
        return call

    with spans.recording(dev) as rec:
        for name in ("item", "tolist", "__int__", "__bool__", "cpu"):
            monkeypatch.setattr(torch.Tensor, name, noted(name, getattr(torch.Tensor, name)))
        monkeypatch.setattr(torch.cuda, "synchronize", noted("synchronize", torch.cuda.synchronize))
        serve.run(b, **RUN_KW)
        monkeypatch.undo()
    assert seen and seen[0] == "synchronize", seen
    assert rec.counters["mems.k3.steps"] == _k3_counters(b, True)["mems.k3.steps"]

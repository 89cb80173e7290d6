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


def _check_tree(rec, res):
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
                            "serve.copy.host_allocs": 0}
    return by_name


def test_recording_off_records_nothing(batch, monkeypatch):
    want = serve.run(batch, **RUN_KW)

    def refuse(*args, **kwargs):
        raise AssertionError("called with recording off and no profiler")

    syncs = []
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "host_memory_stats", refuse)
    monkeypatch.setattr(serve, "_sync", lambda device: syncs.append(device))
    got = serve.run(batch, **RUN_KW)
    assert syncs == [batch.codes.device]
    assert spans._active is None
    for a, b in zip(_arrays(got), _arrays(want)):
        np.testing.assert_array_equal(a, b)
    assert set(got.seconds) == {"tables", "mer_table", "sdict", "windows", "upload", "fetch"}


def test_one_call_gives_the_span_tree(batch):
    rec, (res,) = _record(batch, "cpu")
    by_name = _check_tree(rec, res)
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
    by_name = _check_tree(rec, res)
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

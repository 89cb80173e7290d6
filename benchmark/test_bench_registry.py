"""BENCHMARK.json against the benchmark's contract, and every configuration,
traffic mix and per-layer metric found by its name; an added configuration,
mix and metric run without an edit to any file that is there."""

from __future__ import annotations

import hashlib
import json
import re

import pytest

from benchmark import run, tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = run.load_benchmark()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[kind]]
        assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["chips"] in (1, 4)
        assert _line(w["why"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
    cells = {w["name"] for w in BENCH["workloads"]}
    assert all(set(m.get("workloads", cells)) <= cells for m in BENCH["per_layer"])


def test_every_file_is_found_by_name():
    for w in BENCH["workloads"]:
        cell, cfg, mix = run.cell_files(BENCH, w["name"])
        assert cfg["name"] == cell["config"] and mix["name"] == cell["traffic"]
        entry = run._named(BENCH["configs"], cell["config"], "configuration")
        assert cfg["reduced"] == entry["reduced"] and cfg["source"] in entry["source"]
        assert set(cfg["reduced"]) <= set(cfg["source_values"])
    for m in BENCH["per_layer"]:
        reader = run.load_reader(m["name"])
        assert (reader.UNIT, reader.MOVES, reader.SOURCE) == (m["unit"], m["moves"], m["source"])
        assert callable(reader.read)
    for m in BENCH["end_to_end"]:
        reader = run.load_reader(m["name"])
        assert (reader.UNIT, reader.SOURCE) == (m["unit"], m["source"])
        assert callable(reader.read)


def test_each_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in run.metrics_of(BENCH, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.metrics_of(BENCH, "per_layer", w["name"])


def _digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_an_added_trio_runs_without_an_edit(tmp_path):
    """A configuration, a mix and a metric added as files and entries: the
    harness finds and runs them, and every file already there keeps its
    bytes."""
    root = tiny.make_root(tmp_path / "checkout")
    before = _digests(root / "benchmark")
    (root / "benchmark" / "metrics" / "dummy.calls.py").write_text(
        'UNIT = "calls"\nMOVES = "reads_per_s"\nSOURCE = "program_counter"\n\n\n'
        'def probe(readings, pool, run_kw):\n    readings["dummy"] = len(pool)\n\n\n'
        'def read(r):\n    return len(r["calls"]) + 0 * r["dummy"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "dummy.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "test layer",
                               "moves": "reads_per_s", "workloads": [tiny.TINY_CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line, _ = run.run_cell(tiny.TINY_CELL, 5, 0.5, True, device="cpu", root=root,
                           work_dir=tmp_path / "work")
    assert line["correct"] and line["metrics"]["dummy.calls"]["value"] >= 1
    after = _digests(root / "benchmark")
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("kind", ["workload", "config", "traffic"])
def test_a_missing_name_is_an_error(tmp_path, kind):
    root = tiny.make_root(tmp_path / "checkout")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = bench["workloads"][-1]
    if kind == "workload":
        with pytest.raises(KeyError):
            run.cell_files(bench, "no.such", root)
        return
    if kind == "config":
        cell["config"] = "absent"
        with pytest.raises(KeyError):
            run.cell_files(bench, tiny.TINY_CELL, root)
        return
    cell["traffic"] = "absent"
    with pytest.raises(FileNotFoundError):
        run.cell_files(bench, tiny.TINY_CELL, root)

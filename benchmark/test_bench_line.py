"""The result line's shape, the refusal without a card, and the run in a
directory that holds only the benchmark's files."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run, tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("trace", [0, 1])
def test_the_last_line(root, tmp_path, trace):
    line, notes = run.run_cell(tiny.TINY_CELL, 2**31 + 77, 4.0, bool(trace), device="cpu",
                               root=root, work_dir=tmp_path)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    bench = run.load_benchmark(root)
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"]: m["unit"] for m in run.metrics_of(bench, kind, tiny.TINY_CELL)}
    got = {k: v["unit"] for k, v in line["metrics"].items()}
    if trace:
        # the rooflines read device time, which a CPU run has none of
        assert set(want) - set(got) == {"find_mems_roofline", "query_mem_tags_roofline"}
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    assert all(isinstance(v["value"], float) for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert notes == [f"{k} {v['value']} limit {v['limit']}" for k, v in line["compared"].items()]
    assert set(line["compared"]) == set(run.LIMITS)
    json.dumps(line)


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "pg450m-ckpt.sr150-e1", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA device" in out.err


def test_the_benchmark_alone_does_not_run(tmp_path):
    """In a directory with BENCHMARK.json and benchmark/ only, the program
    is missing: the run fails and prints no result."""
    shutil.copytree(run.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("from benchmark import run; run.run_cell('pg450m-ckpt.sr150-e1', 1, 1.0, False, "
            "device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "pangenome_index_tpu_torch" in p.stderr


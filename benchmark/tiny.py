"""A checkout's root in miniature for the benchmark's tests: a copy of
benchmark/ and BENCHMARK.json beside a tiny configuration, a tiny traffic
mix and their cell, which the program's plain versions serve on the CPU in
seconds. Nothing of the repository is edited: the tiny files are added to
the copy."""

from __future__ import annotations

import json
import pathlib
import shutil

from .run import ROOT

TINY_CELL = "tiny.tinymix"


def make_root(dest: pathlib.Path, *, config: dict | None = None,
              mix: dict | None = None, base: str = "pg450m-ckpt") -> pathlib.Path:
    """Copy benchmark/ and BENCHMARK.json to dest and add the cell
    tiny.tinymix: configuration `base` at 3 haplotypes of 3000 bases with
    small seed tiers (updated by `config`), traffic sr150-e1 at 64 reads of
    60 bases a call (updated by `mix`). Every per-layer metric lists it."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{base}.json").read_text())
    cfg.update({"name": "tiny", "base_len": 3000, "haplotypes": 3, "mer_m": 6, "sdict_s": 11,
                "controls": ["skip_rescan", "int32"], **(config or {})})
    (dest / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    m = json.loads((ROOT / "benchmark" / "traffic" / "sr150-e1.json").read_text())
    m.update({"name": "tinymix", "read_len": 60, "reads_per_call": 64, "pool_batches": 2,
              "traced_calls": 2, "error_rate": 0.03, **(mix or {})})
    (dest / "benchmark" / "traffic" / "tinymix.json").write_text(json.dumps(m))
    bench["configs"].append({"name": "tiny", "source": "a test's", "reduced": [],
                             "file": "benchmark/configs/tiny.json", "why": "tests"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny",
                               "traffic": "tinymix", "chips": 1, "why": "tests"})
    for metric in bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(TINY_CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest

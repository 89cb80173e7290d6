"""The metrics: one file a metric, named as in BENCHMARK.json, each with
`UNIT`, `SOURCE`, a per-layer metric's `MOVES` (the end-to-end metric it
should move), a reader
`read(readings) -> float | None` (None where the run holds nothing to read)
and optionally `probe(readings, pool, run_kw)`, which takes readings of its
own from the prepared pool before the program's state is freed. The
readings a run takes for every metric are described in benchmark/run.py."""

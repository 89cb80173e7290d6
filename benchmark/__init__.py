"""The benchmark of pangenome_index_tpu_torch (BENCHMARK.json at the
checkout's root; `python3 -m benchmark.run --help`)."""

"""Seconds from the process's start to the end of warm-up: imports, the
sequences, the index build, the reads, serve.prepare of the pool and one
call on each batch (a checkout's first run also builds the kernels)."""

UNIT = "s"
SOURCE = "host_clock"


def read(r):
    return r["setup_s"]

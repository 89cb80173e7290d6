"""Seconds of host read windows (serve.prepare's "windows" span: the rolling
seed keys and the dictionary lookups of every read of the pool): set-up work
that a streaming client would pay on every call."""

UNIT = "s"
MOVES = "setup_s"
SOURCE = "program_span"


def read(r):
    return r["windows_s"]

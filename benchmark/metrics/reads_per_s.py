"""Reads whose MEMs and tag counts reached the host, in the calls completed
inside the window, over the window's length."""

UNIT = "reads/s"
SOURCE = "host_clock"


def read(r):
    return sum(c["reads"] for c in r["done"]) / r["window_s"]

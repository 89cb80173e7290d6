"""The roofline bounds of the serving kernels, counted from the logical
content of the work: the reads, the outputs the caller gets and the index's
own data (its runs, its tag runs), never the sizes of the tables the program
derives from them, so that the bound reads the same whatever implements
it. Each input byte is read once, each output byte written once, and the
index's data at most once. Restated from the bytes bounds of chip_smoke.py,
which counted the port's table layouts.

The peak is the published HBM bandwidth of one H100 SXM (80 GB HBM3), at
its 700 W power limit: a card set lower reads a lower share.
"""

PEAK_BYTES_PER_S = 3.35e12


def mems_bytes(reads: int, read_len: int, capacity: int, runs: int,
               pos_bytes: int) -> int:
    """MEM finding of a batch: a byte a base in; a count and `capacity`
    (start, end, bwt_start, size) slots out, read offsets in 4 bytes and BWT
    positions in pos_bytes; the run-length BWT (a symbol and a run head a
    run) read once."""
    reads_in = reads * read_len
    out = reads * (4 + capacity * (2 * 4 + 2 * pos_bytes))
    return reads_in + out + runs * (1 + pos_bytes)


def tags_bytes(reads: int, capacity: int, tag_runs: int, pos_bytes: int) -> int:
    """Tag counts of a batch's MEM slots: counts and (bwt_start, size) slots
    in; a distinct-tag count (4 bytes) and an overflow flag a slot out; the
    tag array (an 8-byte tag and a run head a run) read once."""
    inp = reads * (4 + capacity * 2 * pos_bytes)
    out = reads * capacity * (4 + 1)
    return inp + out + tag_runs * (8 + pos_bytes)


def share(bytes_moved: float, seconds: float) -> float | None:
    """Percent of the bandwidth roofline: the least time the bytes take at
    the peak over the time measured."""
    if seconds <= 0:
        return None
    return 100.0 * bytes_moved / PEAK_BYTES_PER_S / seconds
